"""WordCount (BASELINE config 1): Text keys through the byte-exact path.

The port's copy of ``uda_tpu/models/wordcount.py``: the first workload of
the reference's regression suite (reference
scripts/regression/namesConf.sh:20-35). Text-key comparator semantics
(VInt-prefixed keys, reference CompareFunc.cc:82-86) and the full
supplier -> merger pipeline, the merge on the card.
"""

from __future__ import annotations

import re
import struct
from typing import Iterable, Optional

from uda_tpu_torch.models.pipeline import MapReduceJob, Record
from uda_tpu_torch.utils import vint
from uda_tpu_torch.utils.config import Config

__all__ = ["text_key", "parse_text_key", "run_wordcount"]

_TOKEN = re.compile(rb"[A-Za-z0-9]+")


def text_key(word: bytes) -> bytes:
    """Serialize like org.apache.hadoop.io.Text (VInt length + bytes)."""
    return vint.encode_vlong(len(word)) + word


def parse_text_key(key: bytes) -> bytes:
    n, off = vint.decode_vlong(key, 0)
    return key[off:off + n]


def _mapper(split: bytes) -> Iterable[Record]:
    one = struct.pack(">q", 1)  # LongWritable(1)
    for m in _TOKEN.finditer(split):
        yield text_key(m.group(0).lower()), one


def _reducer(key: bytes, values: list[bytes]) -> Iterable[Record]:
    total = sum(struct.unpack(">q", v)[0] for v in values)
    yield key, struct.pack(">q", total)


def run_wordcount(text: bytes, num_maps: int = 4, num_reducers: int = 2,
                  config: Optional[Config] = None,
                  work_dir: Optional[str] = None,
                  mesh=None, device=None) -> dict[bytes, int]:
    """Run WordCount over ``text`` split into ``num_maps`` chunks; returns
    {word: count} merged across reducers. With ``mesh``, the shuffle
    crosses the slot mesh (MapReduceJob.run_reduces_mesh)."""
    n = len(text)
    step = max(1, n // num_maps)
    splits = []
    start = 0
    # split on whitespace boundaries so tokens are never cut
    while start < n:
        end = min(n, start + step)
        while end < n and text[end:end + 1] not in b" \t\r\n":
            end += 1
        splits.append(text[start:end])
        start = end
    job = MapReduceJob("wordcount", _mapper, _reducer,
                       key_type="org.apache.hadoop.io.Text",
                       num_reducers=num_reducers, config=config,
                       work_dir=work_dir, device=device)
    outputs = job.run(splits, mesh=mesh)
    result: dict[bytes, int] = {}
    for recs in outputs.values():
        for k, v in recs:
            result[parse_text_key(k)] = struct.unpack(">q", v)[0]
    return result
