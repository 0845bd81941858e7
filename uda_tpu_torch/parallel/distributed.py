"""Distributed shuffle+merge: the multi-chip sort step over the slot mesh.

Counterpart of ``uda_tpu/parallel/distributed.py``: per slot,

    partition (splitter search) -> bucket -> all-to-all ->
    local stable sort -> globally sorted, slot-sharded output

Destinations are monotone in the first key word, so after the exchange
slot d holds exactly range-partition d, and the concatenation of the
slots' valid rows is the total order. Delivery is ordered by (source
slot, in-bucket arrival) and the local sort is stable, so that
concatenation equals the single-chip stable sort of the same words, byte
for byte.

The local sort's engines are the reference's (``_sort_valid_rows``): the
lanes engines run the kernel cascade of ``ops/pallas_sort`` (``keys8``
and ``lanes``/``lanes2``: the tile sort K2, the merge pass K1 and its
partition kernel; ``keys8f``: the slim K3/K4) through
``keys8_sort_perm``/``sort_lanes``, the keys8 engines then moving each
record once with the row gather K6 (``ops/lane_gather.take_rows``), as
``models/terasort.single_chip_sort`` does; the others take PyTorch's
stable sort's permutation. On a CPU slot each kernel wrapper runs its plain
version; on the card it launches the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from uda_tpu_torch.ops.lane_gather import take_rows
from uda_tpu_torch.ops.sort import (FOLDED_KEY_ROWS, _as_i64,
                                    apply_perm_chunked, fill_words, i32,
                                    route_engine, stable_lex_argsort, u32,
                                    words_of)
from uda_tpu_torch.parallel.mesh import Mesh, RowSharding
from uda_tpu_torch.parallel.multihost import (put_global, put_rows,
                                              zeros_global)
from uda_tpu_torch.utils.errors import TransportError

__all__ = ["uniform_splitters", "sample_splitters", "distributed_sort_step",
           "distributed_sort_multiround", "DistributedSortResult"]

_INVALID = 0xFFFFFFFF


def uniform_splitters(num_partitions: int) -> np.ndarray:
    """Range splitters on the first key word for uniformly distributed
    keys (TeraSort's keyspace): partition i covers
    [i*2^32/P, (i+1)*2^32/P)."""
    edges = (np.arange(1, num_partitions, dtype=np.uint64)
             * (1 << 32)) // num_partitions
    return edges.astype(np.uint32)


def sample_splitters(first_words: np.ndarray, num_partitions: int,
                     oversample: int = 64) -> np.ndarray:
    """Sampled quantile splitters for skewed key distributions (the
    TotalOrderPartitioner analogue). ``first_words`` is any sample of
    first key words."""
    sample = np.sort(np.asarray(first_words, dtype=np.uint32))
    if sample.size == 0:
        return uniform_splitters(num_partitions)
    idx = (np.arange(1, num_partitions) * sample.size) // num_partitions
    return sample[np.minimum(idx, sample.size - 1)]


class DistributedSortResult:
    """Slot-sharded sorted output of one distributed sort step: ``words``
    holds one uint32 [rows, W] tensor per local slot (its first
    ``valid_counts[k]`` rows valid, the rest padding past every real key),
    ``valid_counts`` and ``send_overflow`` one [1] tensor per local slot.
    The overflow total is gathered from every slot, so it reads the same
    on every process."""

    def __init__(self, words: list, valid_counts: list, send_overflow: list,
                 overflow_total: int, mesh: Mesh):
        self.words = words
        self.valid_counts = valid_counts
        self.send_overflow = send_overflow
        self._overflow_total = int(overflow_total)
        self.mesh = mesh

    def overflow(self) -> int:
        return self._overflow_total

    def valid_rows(self, k: int) -> torch.Tensor:
        """Local slot k's valid rows."""
        return self.words[k][:int(self.valid_counts[k].reshape(-1)[0])]

    def check(self) -> None:
        total = self.overflow()
        if total != 0:
            over = torch.cat([o.reshape(-1) for o in self.mesh.gather_slots(
                self.send_overflow)]).numpy()
            raise TransportError(
                f"exchange capacity overflow on devices "
                f"{np.nonzero(over)[0].tolist()} ({total} records); "
                "raise capacity or use the multi-round path")


def _sort_valid_rows(flat: torch.Tensor, valid: torch.Tensor, num_keys: int,
                     payload_path: str) -> torch.Tensor:
    """Stable local sort of ``flat``'s rows by the first ``num_keys``
    columns, with ``valid``-masked rows forced past every real key (the
    shared tail of the fused step and the multiround accumulator sort).

    "keys8"/"keys8f"/"lanes"/"lanes2": the kernel cascade
    (:func:`_sort_valid_rows_lanes`). "carry": whole rows move by the
    stable-sort permutation; "gather": one column at a time; "gather2":
    the transposed [W, n] view at once; "carrychunk": chunks of columns.
    The sort key is (masked keys, invalid flag) with stability by row
    order, so every engine gives the same bytes."""
    from uda_tpu_torch.ops.sort import LANES_ENGINES

    if payload_path in LANES_ENGINES:
        return _sort_valid_rows_lanes(
            flat, valid, num_keys,
            two_phase=payload_path == "lanes2",
            keys8=payload_path in ("keys8", "keys8f"),
            folded=payload_path == "keys8f")
    n, wcols = flat.shape
    keycols = [torch.where(valid, _as_i64(flat[:, i]), _INVALID)
               for i in range(num_keys)]
    invalid_last = (~valid).to(torch.int64)
    perm = stable_lex_argsort([*keycols, invalid_last])
    w = i32(flat)
    if payload_path == "carry":
        return u32(w[perm])
    if payload_path == "gather2":
        return u32(w.T[:, perm].T.contiguous())
    if payload_path == "carrychunk":
        cols = apply_perm_chunked(perm, list(w.T))
        return u32(torch.stack([i32(c) for c in cols], dim=1))
    return u32(torch.stack([w[:, i][perm] for i in range(wcols)], dim=1))


def _sort_valid_rows_lanes(flat: torch.Tensor, valid: torch.Tensor,
                           num_keys: int, two_phase: bool = False,
                           keys8: bool = False,
                           folded: bool = False) -> torch.Tensor:
    """The lanes engines of :func:`_sort_valid_rows`: the sort key (masked
    key words, invalid flag) as lanes rows, the lane count padded to
    ``pad_pow2(n, 1024)`` with lanes whose keys AND flag are 0xFFFFFFFF,
    so they sort after the invalid rows' (+inf keys, flag 1) and after
    every real lane by arrival; cutting back to n drops exactly them.

    ``keys8``: the cascade on the key rows only (K2 + K1, or K3 + K4 with
    ``folded``), then each row moved once by the permutation (the row
    gather, reading the cascade's int32 tie-break row in place); the record
    width is unbounded, the keys plus the flag at most 7 rows (at most 3
    folded). Otherwise the whole record rides the 32-row layout
    (``sort_lanes``, K2 + K1)."""
    from uda_tpu_torch.ops import pallas_sort

    n, wcols = flat.shape
    dev = flat.device
    first_pay = num_keys + 1             # payload starts past the flag row
    tb = pallas_sort.TB_ROW_DEFAULT
    npad, tile = pallas_sort.pad_pow2(n, 1024)
    k8 = num_keys + 1                    # masked keys + invalid flag
    keyrows = [torch.where(valid, _as_i64(flat[:, i]), _INVALID)
               for i in range(num_keys)] + [(~valid).to(torch.int64)]
    if keys8:
        if k8 > 7:
            raise ValueError(
                f"num_keys={num_keys} does not fit the 8-row keys view; "
                "use payload_path='lanes'")
        if folded and k8 > FOLDED_KEY_ROWS:
            raise ValueError(
                f"keys8f needs num_keys <= 2 here (keys + invalid flag "
                f"must fit the folded 4-row slot); got {num_keys} — use "
                "payload_path='keys8'")
        keyr = fill_words((k8, npad), dev, _INVALID)
        for r, row in enumerate(keyrows):
            i32(keyr)[r, :n] = i32(words_of(row))
        # the n real lanes sort strictly before the padding, so the first
        # n arrival indices all name real rows of flat
        _, perm = pallas_sort.keys8_sort_perm(keyr, tile=tile,
                                              folded=folded)
        return take_rows(flat, perm)
    if first_pay + wcols > tb:
        raise ValueError(
            f"record width {wcols} + {num_keys} keys does not fit the "
            f"{pallas_sort.ROWS}-row lanes layout; use payload_path="
            "'gather'")
    mat = fill_words((pallas_sort.ROWS, npad), dev, _INVALID)
    for r, row in enumerate(keyrows):
        i32(mat)[r, :n] = i32(words_of(row))
    i32(mat)[first_pay:first_pay + wcols, :n] = i32(flat).T
    out = pallas_sort.sort_lanes(mat, num_keys=k8, tb_row=tb, tile=tile,
                                 two_phase=two_phase)
    return u32(i32(out)[first_pay:first_pay + wcols, :n].T.contiguous())


def _global_rows(words, mesh: Mesh) -> int:
    """The global row count of ``words`` (an array, or this process's
    per-slot list, summed over every process's slots)."""
    if not isinstance(words, (list, tuple)):
        return int(words.shape[0])
    local = torch.tensor([sum(int(w.shape[0]) for w in words)])
    if not mesh.distributed:
        return int(local[0])
    per_slot = [local if k == 0 else torch.zeros(1, dtype=local.dtype)
                for k in range(len(mesh.local_slots))]
    return int(sum(int(x[0]) for x in mesh.gather_slots(per_slot)))


def _splitters_on(splitters, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(splitters, dtype=np.uint32).astype(
        np.int64), device=device)


def _dest(w: torch.Tensor, spl: torch.Tensor) -> torch.Tensor:
    """Partition by the first key word (unsigned, ``side="right"``)."""
    return torch.searchsorted(spl, _as_i64(w[:, 0]).contiguous(), right=True)


def _sort_step(mesh: Mesh, ws: list, splitters, axis, capacity: int,
               num_keys: int, payload_path: str, exchange_mode="flat",
               dcn_axis=None, ici_axis=None):
    """The fused step: per slot partition, bucket (stable by arrival),
    one exchange round at window base 0 (rows past the credit window are
    counted as overflow, not silently lost), then the local sort with the
    invalid rows forced last. Each slot's bucketed copy lives only until
    its send buffer is built, each delivery only until it is sorted."""
    from uda_tpu_torch.parallel.exchange import (_bucket_local,
                                                 run_round_body)

    p = mesh.axis_size(axis)
    overflow = [None] * len(ws)

    def src(k):
        w = ws[k]
        spl = _splitters_on(splitters, w.device)
        sw, sd, pos, counts = _bucket_local(w, _dest(w, spl), p)
        overflow[k] = torch.clamp(counts - capacity, min=0).sum()[None]
        return sw, sd, pos

    flats, recv_counts = run_round_body(mesh, src, 0, capacity, axis,
                                        exchange_mode, dcn_axis, ici_axis)
    outs, nvalid = [], []
    for k in range(len(flats)):
        flat, flats[k] = flats[k], None
        row = torch.arange(p * capacity, device=flat.device)
        valid = (row % capacity) < recv_counts[k][row // capacity]
        outs.append(_sort_valid_rows(flat, valid, num_keys, payload_path))
        del flat
        nvalid.append(recv_counts[k].sum()[None])
    total = int(sum(int(o[0]) for o in mesh.gather_slots(overflow)))
    return outs, nvalid, overflow, total


def distributed_sort_step(words, splitters, mesh: Mesh, axis,
                          capacity: int, num_keys: int,
                          payload_path: str = "auto",
                          multiround: str = "auto",
                          exchange_mode: str = "auto"
                          ) -> DistributedSortResult:
    """Run the fused partition/exchange/sort step.

    ``words``: uint32[N, W] records (a global array, or this process's
    per-slot list from ``multihost.shard_rows``; the first ``num_keys``
    columns are the big-endian key words). ``axis``: one mesh axis name,
    or a TUPLE for pod meshes (``("dcn", "ici")``); results are
    byte-identical to the flat mesh of the same slot order.
    ``exchange_mode``: ``"auto"`` runs the two-stage body on pod meshes,
    ``"flat"`` the single-stage one, ``"hierarchical"`` demands a pod
    mesh, ``"coded"`` codes the windows the plan approves on the
    multiround path (the fused attempt runs the plain staged body).
    ``capacity``: per-(src, dst) records per round. ``payload_path``: the
    local sort's engine ("auto" resolves through ``route_engine`` on the
    GLOBAL row count and ``num_keys + 1`` key rows, the keys and the
    invalid flag: ``carry`` on the CPU; on the card ``keys8f`` where they
    fit its 3 rows, else ``keys8``, and ``carrychunk`` for a batch below
    2^20 rows there). ``multiround``:
    "auto" runs the fused step and, if any bucket overflowed, re-runs the
    shuffle through the windowed multi-round exchange; "never" reports
    the overflow in the result; "always" skips the fused attempt."""
    from uda_tpu_torch.parallel.exchange import (exchange_dispatch,
                                                 resolve_exchange_mode)

    if multiround not in ("auto", "never", "always"):
        raise ValueError(f"unknown multiround policy {multiround!r}")
    payload_path = route_engine(_global_rows(words, mesh), payload_path,
                                lanes_ok=True, device=mesh.devices[0],
                                key_rows=num_keys + 1)
    topo, hier, _coded = resolve_exchange_mode(mesh, axis, exchange_mode)
    if multiround == "always":
        return distributed_sort_multiround(words, splitters, mesh, axis,
                                           capacity, num_keys, payload_path,
                                           exchange_mode)
    ws = put_rows(words, mesh, axis)
    outs, nvalid, overflow, total = _sort_step(
        mesh, ws, splitters, axis, capacity, num_keys, payload_path,
        **exchange_dispatch(topo, hier))
    res = DistributedSortResult(outs, nvalid, overflow, total, mesh)
    if multiround == "auto" and res.overflow() != 0:
        del res, outs
        return distributed_sort_multiround(ws, splitters, mesh, axis,
                                           capacity, num_keys, payload_path,
                                           exchange_mode)
    return res


def _round_scatter(layout, acc: list, colbase: np.ndarray, r: int,
                   capacity: int, exchange_mode="flat", dcn_axis=None,
                   ici_axis=None, coded_l_rows=None) -> list:
    """One windowed round scattered into the accumulator, in place. The
    accumulator holds each slot's final shard grouped by (src peer,
    in-bucket arrival): the row from peer s with in-bucket position q
    lands at ``colbase[s] + q``; rows outside the window or past a peer's
    count go to the accumulator's last row, the trash row sliced off
    before the sort."""
    from uda_tpu_torch.parallel.exchange import run_round_body

    mesh = layout.mesh
    p = mesh.axis_size(layout.axis)
    lo = r * capacity
    flats, recv_counts = run_round_body(mesh, layout.source(), lo, capacity,
                                        layout.axis, exchange_mode,
                                        dcn_axis, ici_axis, coded_l_rows)
    for k, slot in enumerate(mesh.local_slots):
        dev = acc[k].device
        cb = torch.as_tensor(colbase[mesh.axis_index(slot, layout.axis)],
                             device=dev)
        row = torch.arange(p * capacity, device=dev)
        peer = row // capacity
        slot_in = row % capacity
        valid = slot_in < recv_counts[k][peer]
        idx = torch.where(valid, cb[peer] + lo + slot_in,
                          acc[k].shape[0] - 1)
        i32(acc[k])[idx] = i32(flats[k])
    return acc


def distributed_sort_multiround(words, splitters, mesh: Mesh, axis,
                                capacity: int, num_keys: int,
                                payload_path: str = "auto",
                                exchange_mode: str = "auto"
                                ) -> DistributedSortResult:
    """Skew-proof distributed sort: the windowed multi-round exchange
    scattered into a shard-sized accumulator, then one local sort.

    The schedule comes from the gathered count matrix (planned by
    ``parallel/planner.py``: empty windows skipped, per-axis accounting
    per executed round), so every bucket, however skewed, drains. The
    accumulator is laid out by ``colbase`` (each destination's rows
    grouped by source slot, then in-bucket arrival), so the stable sort
    reproduces the fused step's equal-key order exactly."""
    from uda_tpu_torch.parallel.exchange import (execute_planned_window,
                                                 prepare_layout)
    from uda_tpu_torch.parallel.planner import (plan_layout_rounds,
                                                record_plan_skips)

    wcols = int((words[0] if isinstance(words, (list, tuple))
                 else words).shape[1])
    payload_path = route_engine(_global_rows(words, mesh), payload_path,
                                lanes_ok=True, device=mesh.devices[0],
                                key_rows=num_keys + 1)
    p = mesh.axis_size(axis)
    ws = put_rows(words, mesh, axis)
    dests = [_dest(w, _splitters_on(splitters, w.device)) for w in ws]
    layout = prepare_layout(ws, dests, mesh, axis, exchange_mode)
    del ws, dests
    counts = layout.counts                      # [src, dst]
    plan = plan_layout_rounds(layout, capacity)
    colbase = np.zeros((p, p), np.int64)        # [dst, src] exclusive cumsum
    colbase[:, 1:] = np.cumsum(counts.T[:, :-1], axis=1)
    per_dst = counts.sum(axis=0).astype(np.int64)
    shard_rows = max(int(per_dst.max()), 1)
    sharding = RowSharding(mesh, axis)
    # one trash row past the shard, sliced off below
    acc = zeros_global((p * (shard_rows + 1), wcols), torch.uint32,
                       sharding)
    dispatch = layout.dispatch()
    for win in plan.windows:
        # the shared coded-window dispatch; the exchange.decode failpoint
        # fires before the scatter runs, so the fallback scatters into an
        # untouched accumulator
        acc = execute_planned_window(
            win, plan,
            lambda: _round_scatter(
                layout, acc, colbase, win.index, capacity,
                **dict(dispatch, exchange_mode="coded",
                       coded_l_rows=plan.coded_l_rows)),
            lambda: _round_scatter(layout, acc, colbase, win.index,
                                   capacity, **dispatch))
    record_plan_skips(plan)
    del layout
    nvalid = put_global(per_dst, sharding)
    outs = []
    for k in range(len(acc)):
        a, acc[k] = acc[k][:shard_rows], None
        row = torch.arange(shard_rows, device=a.device)
        outs.append(_sort_valid_rows(a, row < nvalid[k][0], num_keys,
                                     payload_path))
        del a
    overflow = [torch.zeros(1, dtype=torch.int64, device=d)
                for d in mesh.devices]
    return DistributedSortResult(outs, nvalid, overflow, 0, mesh)
