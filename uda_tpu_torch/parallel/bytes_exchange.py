"""Opaque-bytes transport over the mesh + the exchange-fed fetch client.

The port's copy of ``uda_tpu/parallel/bytes_exchange.py``: the packing,
the exchange and the reassembly are the reference's, the exchange the
port's ``shuffle_exchange`` over the slot mesh.

The reference moves IFile segment bytes between hosts with one-sided
RDMA-WRITEs into registered buffers (reference src/DataNet/
RDMAServer.cc:537-631, consumed by the reduce-side InputClient,
src/Merger/InputClient.h:30-56). The mesh equivalent here:

- ``exchange_blobs``: pack arbitrary byte blobs into fixed-stride
  uint32 rows (2 header words — blob id, valid bytes — plus the
  payload slice) and move them with the SAME windowed all-to-all the
  record exchange uses (parallel.exchange.shuffle_exchange). Round
  windows walk the in-bucket position in order and each round's valid
  rows are delivered densely per source, so per-(src, dst) byte order
  is preserved end-to-end and reassembly is a linear scan.
- ``ExchangeFetchClient``: an InputClient serving the delivered
  segments to the reduce-side MergeManager chunk by chunk — the full
  reference flow (supplier MOF -> transport -> reduce-side merge) with
  the device mesh as the wire instead of an RDMA fabric.

Together with merger.MergeManager this closes the loop the reference
calls "network levitation": the transport tier and the merge tier are
separate components joined only by the InputClient contract, so either
side can be swapped (DataEngine locally, the mesh across chips).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from uda_tpu_torch.merger.segment import InputClient
from uda_tpu_torch.mofserver.data_engine import FetchResult, ShuffleRequest
from uda_tpu_torch.parallel.mesh import Mesh
from uda_tpu_torch.utils.errors import MergeError

__all__ = ["exchange_blobs", "exchange_group_size", "ExchangeFetchClient"]


def exchange_group_size(mesh: Mesh, axis) -> int:
    """Number of exchange participants = product of the NAMED axes only
    (a multi-axis mesh with a single exchange axis runs one independent
    exchange per replica of the other axes; counting all axes would
    address dests the all_to_all never reaches and silently drop their
    rows). The one rule callers sizing ``blobs`` must share."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return int(np.prod([mesh.shape[a] for a in axes]))

_SENTINEL = np.uint32(0xFFFFFFFF)   # blob id of padding rows
_HDR_WORDS = 2                      # [blob_id, valid_bytes]


def _pack_src(items: Sequence[Tuple[int, bytes]], row_payload: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """One source's blobs -> (rows uint32[N, W], dest int32[N]).
    Every blob becomes ceil(len/row_payload) rows (an empty blob still
    emits one valid=0 row so it reassembles as b'')."""
    w = _HDR_WORDS + row_payload // 4
    rows, dest = [], []
    for blob_id, (dst, data) in enumerate(items):
        chunks = ([data[o:o + row_payload]
                   for o in range(0, len(data), row_payload)] or [b""])
        for chunk in chunks:
            row = np.zeros(w, np.uint32)
            row[0] = blob_id
            row[1] = len(chunk)
            padded = chunk + b"\0" * (row_payload - len(chunk))
            row[_HDR_WORDS:] = np.frombuffer(padded, np.uint32)
            rows.append(row)
            dest.append(dst)
    return (np.stack(rows) if rows else np.zeros((0, w), np.uint32),
            np.asarray(dest, np.int32))


def exchange_blobs(blobs: Sequence[Sequence[Tuple[int, bytes]]],
                   mesh: Mesh, axis: str,
                   capacity: Optional[int] = None,
                   row_payload_bytes: int = 256
                   ) -> list[list[list[bytes]]]:
    """Move byte blobs across the mesh: ``blobs[src]`` is that source
    device's send list of ``(dst_device, payload)`` pairs; returns
    ``out[dst][src]`` = the payloads from ``src`` to ``dst`` in send
    order. ``capacity`` is the per-(src, dst) row window per round
    (default: one round, sized to the largest bucket).
    """
    from uda_tpu_torch.parallel.exchange import shuffle_exchange

    p = exchange_group_size(mesh, axis)
    if len(blobs) != p:
        raise ValueError(f"blobs has {len(blobs)} sources for a {p}-way "
                         f"exchange over {axis!r}")
    for s, items in enumerate(blobs):
        for dst, _ in items:
            if not 0 <= dst < p:
                raise ValueError(f"source {s}: dest {dst} outside the "
                                 f"{p}-way exchange group")
    if row_payload_bytes <= 0 or row_payload_bytes % 4:
        raise ValueError("row_payload_bytes must be a positive multiple "
                         "of 4")
    packed = [_pack_src(items, row_payload_bytes) for items in blobs]
    w = _HDR_WORDS + row_payload_bytes // 4
    nmax = max((r.shape[0] for r, _ in packed), default=0) or 1
    words = np.zeros((p * nmax, w), np.uint32)
    dest = np.zeros(p * nmax, np.int32)
    for s, (rows, d) in enumerate(packed):
        n = rows.shape[0]
        words[s * nmax:s * nmax + n] = rows
        dest[s * nmax:s * nmax + n] = d
        # padding rows: sentinel blob id, dest 0, valid 0 — they ride
        # the exchange and are skipped at reassembly
        words[s * nmax + n:(s + 1) * nmax, 0] = _SENTINEL
    if capacity is None:
        counts = np.zeros((p, p), np.int64)
        for s, (_, d) in enumerate(packed):
            np.add.at(counts[s], d, 1)
        counts[:, 0] += nmax - np.asarray([r.shape[0] for r, _ in packed])
        capacity = max(1, int(counts.max()))

    from uda_tpu_torch.parallel.multihost import allgather

    results, _ = shuffle_exchange(words, dest, mesh, axis, capacity)
    cap = capacity
    streams: list[list[list[np.ndarray]]] = [
        [[] for _ in range(p)] for _ in range(p)]
    for recv_words, recv_counts in results:
        # allgather: every slot's delivery on every process
        rw = allgather(mesh, recv_words, axis).reshape(p, p, cap, w)
        rc = allgather(mesh, recv_counts, axis).reshape(p, p)
        for d in range(p):
            for s in range(p):
                if rc[d, s]:
                    streams[d][s].append(rw[d, s, :rc[d, s]])

    out: list[list[list[bytes]]] = [[[] for _ in range(p)] for _ in range(p)]
    for d in range(p):
        for s in range(p):
            if not streams[d][s]:
                continue
            rows = np.concatenate(streams[d][s])
            cur_id, parts = None, []
            for row in rows:
                if row[0] == _SENTINEL:
                    continue
                if cur_id is not None and row[0] != cur_id:
                    out[d][s].append(b"".join(parts))
                    parts = []
                cur_id = int(row[0])
                parts.append(row[_HDR_WORDS:].tobytes()[:int(row[1])])
            if cur_id is not None:
                out[d][s].append(b"".join(parts))
    return out


class ExchangeFetchClient(InputClient):
    """Reduce-side InputClient over mesh-delivered segments.

    ``segments`` maps map id -> that map output's partition bytes for
    THIS reduce task (as delivered by exchange_blobs). Fetches complete
    inline — the bytes already crossed the wire; chunking preserves the
    Segment carry-buffer contract (records split across chunks) so the
    whole reduce-side stack behaves exactly as over the RDMA-style
    transport.

    ``raw_lengths`` carries each partition's UNCOMPRESSED size when the
    exchanged bytes are codec-compressed (the spill index's raw_length
    vs part_length split). It exists for FetchResult CONTRACT fidelity —
    the reference ACK carries both lengths (RDMAServer.cc:597-607) —
    not because the decompression path needs it: DecompressingClient
    tracks uncompressed progress itself and never reads the inner
    raw_length. Defaults to the on-wire length — correct ONLY for
    uncompressed segments, so callers exchanging codec-compressed bytes
    MUST pass ``raw_lengths`` (run_reduces_mesh does) or
    FetchResult.raw_length misreports the part_length."""

    def __init__(self, segments: dict[str, bytes],
                 raw_lengths: Optional[dict[str, int]] = None):
        self._segments = dict(segments)
        self._raw = dict(raw_lengths or {})

    def start_fetch(self, req: ShuffleRequest, on_complete) -> None:
        data = self._segments.get(req.map_id)
        if data is None:
            on_complete(MergeError(f"no exchanged segment for map "
                                   f"{req.map_id!r}"))
            return
        chunk = data[req.offset:req.offset + req.chunk_size]
        last = req.offset + len(chunk) >= len(data)
        on_complete(FetchResult(chunk,
                                self._raw.get(req.map_id, len(data)),
                                len(data), req.offset,
                                f"mesh://{req.map_id}", last))
