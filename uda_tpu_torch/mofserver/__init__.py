"""Map-output supplier of the port (the MOFServer/ layer): index
resolution, the map-output writer, the chunk-serving data engine and the
elastic disaggregated store."""

from uda_tpu_torch.mofserver.data_engine import (DataEngine, FdSlice,
                                                 FetchResult, ShuffleRequest)
from uda_tpu_torch.mofserver.index import (DirIndexResolver, IndexRecord,
                                           IndexResolver, PartitionStripe,
                                           read_index_file, write_index_file)
from uda_tpu_torch.mofserver.store import (BackendHealth, BlobStore,
                                           LocalFdStore, MOFStore,
                                           StoreManager,
                                           spill_watermark_bytes)
from uda_tpu_torch.mofserver.writer import (MOFWriter, write_map_output,
                                            write_striped_map_output)

__all__ = ["DataEngine", "FdSlice", "FetchResult", "ShuffleRequest",
           "DirIndexResolver", "IndexRecord", "IndexResolver",
           "PartitionStripe", "read_index_file", "write_index_file",
           "MOFWriter", "write_map_output", "write_striped_map_output",
           "BackendHealth", "BlobStore", "LocalFdStore", "MOFStore",
           "StoreManager", "spill_watermark_bytes"]
