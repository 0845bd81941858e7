"""The shuffle data plane: wire framing, the supplier-side socket server
and the reduce-side multiplexed fetch client, the TCP stand-in for the
reference's RDMAServer/RDMAClient ibverbs plane, and the push plane
(``net/push.py``). The port's copy of ``uda_tpu/net``. A supplier
listens next to its DataEngine and reduce hosts dial it through
``HostRoutingClient``'s default socket factory.
"""

from uda_tpu_torch.net.client import RemoteFetchClient, fetch_remote_stats
from uda_tpu_torch.net.server import ShuffleServer
from uda_tpu_torch.net.wire import MAX_FRAME, WIRE_VERSION

__all__ = ["RemoteFetchClient", "ShuffleServer", "WIRE_VERSION",
           "MAX_FRAME", "fetch_remote_stats"]
