"""The shuffle data plane: windowed all-to-all exchange over the slot mesh.

Counterpart of ``uda_tpu/parallel/exchange.py``. The exchange is globally
scheduled, as in the reference:

- every slot buckets its records by destination partition;
- each round moves at most ``capacity`` records per (src, dst) pair
  through one all-to-all over the named mesh axis (the credit window);
- skewed destinations take more rounds.

Records travel as fixed-stride ``uint32`` row matrices. A round body runs
once per slot in a Python loop, and the all-to-alls between its stages
are the mesh's collectives (``parallel/mesh.py``). A body takes its
per-slot inputs through ``src(k) -> (words, dest, pos)`` for local slot k,
called once per slot while the send buffers are built, so a caller that
computes them on the fly (the fused sort step) never holds every slot's
bucketed copy at once.

Hierarchical meshes (``(dcn, ici)``): the two-stage body stages each
cross-pod record onto the ONE egress chip of its (pod, peer-pod) pair
over ICI, moves one coalesced tile per pod pair over DCN and delivers
with a second pod-local scatter. Every staged row carries a tag column,
``src_slot * capacity + slot + 1``, and the final scatter puts row
``tag - 1`` of the flat ``[P*capacity, W]`` layout, so the output is the
flat body's byte for byte. The coded body (``mode="coded"``) compacts
each destination chip's rows into an ``l_rows`` block, GF(2^8)-encodes
the pod's blocks through a full-rank Cauchy matrix (``coding/gfjax``),
ships the coded tile over DCN, broadcasts it pod-locally (an all-gather
over ICI) and lets each member decode its own block; the tags ride
through encode and decode. The host plan (``parallel/planner.py``)
decides which windows code; a decode failure (failpoint
``exchange.decode``) falls back to the plain tile within the round.

Torch's thin ``uint32``: the buckets, ranks and tags are int64/int32
values, the words move through int32 views, and every scatter has an
explicit trash row or slot that is sliced off (the reference's
``mode="drop"``): an index outside the buffer raises instead of being
dropped.

The byte accounting is the reference's: the planner counts record rows
(the populated payload); the dense buffers additionally carry empty slots.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from uda_tpu_torch.ops.sort import i32, u32
from uda_tpu_torch.parallel.mesh import Mesh, MeshTopology, mesh_topology
from uda_tpu_torch.parallel.multihost import allgather, put_rows
from uda_tpu_torch.utils.errors import (ConfigError, StorageError,
                                        TransportError)
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.ifile import RecordBatch
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["ShuffleLayout", "prepare_layout", "window_round_body",
           "hierarchical_round_body", "coded_round_body",
           "run_round_body", "resolve_exchange_mode",
           "exchange_dispatch", "exchange_round",
           "execute_planned_window", "shuffle_exchange",
           "exchange_record_batches"]

EXCHANGE_MODES = ("auto", "flat", "hierarchical", "coded")

# per-slot round inputs: src(k) -> (words uint32[n, W], dest [n], pos [n])
Source = Callable[[int], tuple]


def resolve_exchange_mode(mesh: Mesh, axis, mode: str = "auto"):
    """Resolve the exchange dispatch for a (mesh, axis) pair: returns
    ``(topology, hierarchical, coded)``. ``auto`` takes the two-stage path
    exactly when the mesh has a real pod structure; ``flat`` forces the
    single-stage path; ``hierarchical`` demands a pod mesh and refuses
    otherwise; ``coded`` arms the coded stage B on pod meshes and is the
    plain path elsewhere."""
    if mode not in EXCHANGE_MODES:
        raise ConfigError(f"unknown exchange mode {mode!r} "
                          f"(one of {EXCHANGE_MODES})")
    topo = mesh_topology(mesh, axis)
    if mode == "hierarchical" and not topo.hierarchical:
        raise ConfigError(
            f"exchange mode 'hierarchical' needs a (dcn, ici) mesh with "
            f">1 pod of >1 chip; got axes {axis!r} on mesh "
            f"{dict(mesh.shape)}")
    hier = topo.hierarchical if mode in ("auto", "coded") \
        else mode == "hierarchical"
    return topo, hier, (mode == "coded" and topo.hierarchical)


def exchange_dispatch(topology: Optional[MeshTopology],
                      hierarchical: bool) -> dict:
    """The dispatch every exchange entry point shares (the plain
    exchange, the fused sort step and the multiround scatter), so they
    can never disagree on which round body a mesh runs."""
    hier = bool(hierarchical) and topology is not None
    return {"exchange_mode": "hierarchical" if hier else "flat",
            "dcn_axis": topology.dcn_axis if hier else None,
            "ici_axis": topology.ici_axis if hier else None}


@dataclasses.dataclass
class ShuffleLayout:
    """Per-slot bucketed layout, computed once per shuffle. Each of
    ``words`` (uint32[N, W], ordered by destination), ``dest`` and ``pos``
    (int64 [N], the position in the (src, dst) bucket: ``pos // capacity``
    is the round it travels in) holds one tensor per local slot;
    ``counts`` is the full [P, P] count matrix (row = src slot) on the
    host; ``topology``/``hierarchical``/``coded`` the resolved dispatch."""

    words: list
    dest: list
    pos: list
    counts: np.ndarray
    mesh: Mesh
    axis: object
    topology: Optional[MeshTopology] = None
    hierarchical: bool = False
    coded: bool = False

    def dispatch(self) -> dict:
        """The round-body dispatch (see :func:`exchange_dispatch`)."""
        return exchange_dispatch(self.topology, self.hierarchical)

    def record_bytes(self) -> int:
        """Wire stride of one record row: the byte unit of the planner's
        ICI/DCN accounting."""
        w = self.words[0]
        return int(w.shape[1]) * w.element_size()

    def source(self) -> Source:
        return lambda k: (self.words[k], self.dest[k], self.pos[k])


def _bucket_local(words: torch.Tensor, dest: torch.Tensor, p: int):
    """Stable local bucket-by-destination; returns sorted rows, dest,
    in-bucket positions and per-dest counts (int64)."""
    dest = dest.to(torch.int64)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    swords = u32(i32(words)[order])
    counts = torch.bincount(sdest, minlength=p)[:p]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(sdest.shape[0], device=dest.device) - starts[sdest]
    return swords, sdest, pos, counts


def prepare_layout(words, dest, mesh: Mesh, axis,
                   mode: str = "auto") -> ShuffleLayout:
    """Bucket every slot's records and gather the count matrix. ``words``
    and ``dest`` are global arrays or per-slot lists; ``mode`` resolves
    the fabric dispatch (:func:`resolve_exchange_mode`)."""
    topo, hier, coded = resolve_exchange_mode(mesh, axis, mode)
    p = mesh.axis_size(axis)
    ws = put_rows(words, mesh, axis)
    ds = put_rows(dest, mesh, axis)
    sw, sd, pos, counts = [], [], [], []
    for w, d in zip(ws, ds):
        a, b, c, n = _bucket_local(w, d, p)
        sw.append(a)
        sd.append(b)
        pos.append(c)
        counts.append(n[None])
    mat = allgather(mesh, counts, axis)
    return ShuffleLayout(sw, sd, pos, mat, mesh, axis, topo, hier, coded)


def _scatter(shape, idx: tuple, rows: torch.Tensor) -> torch.Tensor:
    """A zero int32 buffer of ``shape`` with ``rows`` (32-bit words) put at
    ``idx``; the buffer's last row or slot along the indexed axes is the
    trash the caller slices off."""
    buf = torch.zeros(shape, dtype=torch.int32, device=rows.device)
    buf[idx] = i32(rows)
    return buf


def window_round_body(mesh: Mesh, src: Source, lo: int, axis,
                      capacity: int):
    """One windowed exchange round over every local slot (the single
    definition of the round wire protocol; the exchange and the
    multiround scatter both build on it). ``lo`` is the window base.

    Returns ``(flat, recv_counts)``, lists over local slots: the
    [P*capacity, W] delivery (row block i = peer i's contribution) and the
    per-peer valid counts [P]."""
    p = mesh.axis_size(axis)
    sends, counts = [], []
    wcols = 0
    for k in range(len(mesh.local_slots)):
        w, d, q = src(k)
        wcols = w.shape[1]
        in_round = (q >= lo) & (q < lo + capacity)
        slot = torch.where(in_round, q - lo, capacity)  # overflow -> trash
        send = _scatter((p, capacity + 1, wcols), (d, slot), w)
        sends.append(u32(send[:, :capacity]))
        counts.append(torch.bincount(torch.where(in_round, d, p),
                                     minlength=p + 1)[:p, None])
    recv = mesh.all_to_all(sends, axis)
    recv_counts = mesh.all_to_all(counts, axis)
    return ([r.reshape(p * capacity, wcols) for r in recv],
            [c.reshape(p) for c in recv_counts])


def _staged_stage_a(mesh: Mesh, src: Source, lo: int, dcn_axis: str,
                    ici_axis: str, capacity: int):
    """The staged bodies' shared prologue and stage A (pod-local
    all-to-all: intra-pod records straight to their final chip, cross-pod
    records onto the pair's egress chip, every row tagged ``src_slot *
    capacity + slot + 1`` in an extra int32 column). Returns ``(p, c, m,
    wcols, intra_rows, cross)``, the last two lists over local slots,
    ``cross[k]`` shaped [src chip, peer-pod rank, dst chip, slot, word]."""
    p = mesh.axis_size(dcn_axis)        # pods
    c = mesh.axis_size(ici_axis)        # chips per pod
    m = -(-p // c)                      # peer-pod slots per egress chip
    rows_a = capacity + m * c * capacity
    sends = []
    wcols = 0
    for k, me in enumerate(mesh.local_slots):
        g = mesh.axis_index(me, dcn_axis)
        i = mesh.axis_index(me, ici_axis)
        w, d, q = src(k)
        wcols = w.shape[1]
        in_round = (q >= lo) & (q < lo + capacity)
        slot = q - lo
        tag = ((g * c + i) * capacity + slot + 1).to(torch.int32)
        ext = torch.cat([i32(w), tag[:, None]], dim=1)
        dpod = d // c
        dchip = d % c
        intra = dpod == g
        blk = torch.where(intra, dchip, (g + dpod) % c)
        row = torch.where(intra, slot,
                          capacity + (dpod // c) * (c * capacity)
                          + dchip * capacity + slot)
        row = torch.where(in_round, row, rows_a)    # trash row, sliced off
        sends.append(_scatter((c, rows_a + 1, wcols + 1), (blk, row),
                              ext)[:, :rows_a])
    recv_a = mesh.all_to_all(sends, ici_axis)
    wex = wcols + 1
    intra_rows = [r[:, :capacity].reshape(c * capacity, wex) for r in recv_a]
    cross = [r[:, capacity:].reshape(c, m, c, capacity, wex) for r in recv_a]
    return p, c, m, wcols, intra_rows, cross


def _peers(mesh: Mesh, slot: int, dcn_axis: str, ici_axis: str, p: int,
           c: int, m: int) -> torch.Tensor:
    """The peer pods whose pair tiles this chip stages (as egress) and
    receives (as ingress): g' = ((i - g) mod c) + k*c for rank k."""
    g = mesh.axis_index(slot, dcn_axis)
    i = mesh.axis_index(slot, ici_axis)
    return ((i - g) % c) + torch.arange(m) * c


def _stage_b(mesh: Mesh, tiles: list, dcn_axis: str, ici_axis: str, p: int,
             c: int, m: int) -> list:
    """Stage B: each egress chip's tiles, one per peer pod, over the DCN
    all-to-all; returns per slot the m arrived tiles of the pods it
    ingresses for (zero where the rank has no pod)."""
    sends = []
    for k, me in enumerate(mesh.local_slots):
        peers = _peers(mesh, me, dcn_axis, ici_axis, p, c, m).to(
            tiles[k].device)
        sends.append(_scatter((p + 1, *tiles[k].shape[1:]),
                              (torch.where(peers < p, peers, p),),
                              tiles[k])[:p])
    recv_b = mesh.all_to_all(sends, dcn_axis)
    out = []
    for k, me in enumerate(mesh.local_slots):
        peers = _peers(mesh, me, dcn_axis, ici_axis, p, c, m).to(
            recv_b[k].device)
        compact = recv_b[k][torch.clamp(peers, max=p - 1)]
        out.append(torch.where((peers < p)[:, None, None], compact, 0))
    return out


def _tag_assemble(arrived: torch.Tensor, wcols: int, nd: int,
                  capacity: int):
    """The staged bodies' shared delivery: tag - 1 IS the output row of
    the flat ``[P*capacity, W]`` layout (0 marks an empty slot), and
    recv_counts come from the tags' source slots."""
    atag = arrived[:, wcols].to(torch.int64)
    valid = atag > 0
    idx = torch.where(valid, atag - 1, nd * capacity)
    out = _scatter((nd * capacity + 1, wcols), (idx,),
                   arrived[:, :wcols])[:nd * capacity]
    peer = torch.where(valid, (atag - 1) // capacity, nd)
    recv_counts = torch.bincount(peer, minlength=nd + 1)[:nd]
    return u32(out), recv_counts


def hierarchical_round_body(mesh: Mesh, src: Source, lo: int,
                            dcn_axis: str, ici_axis: str, capacity: int):
    """The two-stage (pod-local + coalesced DCN) round body: the same
    window semantics and delivery contract as :func:`window_round_body`.

    - stage A (ICI all-to-all): intra-pod records to their final chip,
      cross-pod records to the egress chip ``(g + g') % c`` of their pair;
    - stage B (DCN all-to-all): each egress chip moves ONE coalesced tile
      per peer pod;
    - stage C (ICI all-to-all): the ingress chip scatters arrived rows to
      their final chips, and the tags place every row."""
    p, c, m, wcols, intra_rows, cross = _staged_stage_a(
        mesh, src, lo, dcn_axis, ici_axis, capacity)
    nd = p * c
    wex = wcols + 1
    tiles = [x.transpose(0, 1).reshape(m, c * c * capacity, wex)
             for x in cross]
    arrived_b = _stage_b(mesh, tiles, dcn_axis, ici_axis, p, c, m)
    sends = [x.reshape(m, c, c, capacity, wex).permute(2, 0, 1, 3, 4)
             .reshape(c, m * c * capacity, wex) for x in arrived_b]
    recv_c = mesh.all_to_all(sends, ici_axis)
    flats, counts = [], []
    for k in range(len(mesh.local_slots)):
        arrived = torch.cat([intra_rows[k],
                             recv_c[k].reshape(c * m * c * capacity, wex)])
        f, n = _tag_assemble(arrived, wcols, nd, capacity)
        flats.append(f)
        counts.append(n)
    return flats, counts


def coded_round_body(mesh: Mesh, src: Source, lo: int, dcn_axis: str,
                     ici_axis: str, capacity: int, l_rows: int):
    """The CODED two-stage round body (Coded TeraSort's multicast phase,
    arXiv:1702.04850): stage A as the hierarchical body; the egress chip
    compacts each destination chip's rows to the front of an
    ``l_rows``-row block (the plan guarantees every block fits) and
    encodes the ``c`` blocks through the Cauchy matrix; stage B moves one
    ``[c, l_rows]`` coded tile per pod pair; stage C all-gathers the
    arrived tiles over ICI and each member decodes its own block with the
    inverse row of its chip index. The tags ride inside the coded words,
    so the final scatter is the flat layout."""
    from uda_tpu_torch.coding.gfjax import (coded_matrices, gf_decode_row,
                                            gf_matmul_words)

    p, c, m, wcols, intra_rows, cross = _staged_stage_a(
        mesh, src, lo, dcn_axis, ici_axis, capacity)
    nd = p * c
    wex = wcols + 1
    enc, dec = coded_matrices(c)
    tiles = []
    for x in cross:
        # [src chip, peer rank, dst chip, slot, word] -> [peer rank, dst
        # chip, (src chip, slot), word]
        full = x.permute(1, 2, 0, 3, 4).reshape(m, c, c * capacity, wex)
        populated = full[:, :, :, wcols] > 0
        rank = torch.cumsum(populated.to(torch.int64), dim=2) - 1
        idx = torch.where(populated, rank, l_rows)
        mi = torch.arange(m, device=x.device)[:, None, None]
        ci = torch.arange(c, device=x.device)[None, :, None]
        blocks = _scatter((m, c, l_rows + 1, wex), (mi, ci, idx),
                          full)[:, :, :l_rows]
        coded = gf_matmul_words(enc, u32(blocks.transpose(0, 1)))
        tiles.append(i32(coded).transpose(0, 1).reshape(m, c * l_rows, wex))
    arrived_b = _stage_b(mesh, tiles, dcn_axis, ici_axis, p, c, m)
    gathered = mesh.all_gather(arrived_b, ici_axis)
    flats, counts = [], []
    for k, me in enumerate(mesh.local_slots):
        chunks = gathered[k].reshape(c, m, c, l_rows, wex).permute(
            2, 0, 1, 3, 4)          # [chunk t, ingress, peer rank, l, word]
        mine = gf_decode_row(dec, mesh.axis_index(me, ici_axis),
                             u32(chunks.contiguous()))
        arrived = torch.cat([intra_rows[k],
                             i32(mine).reshape(c * m * l_rows, wex)])
        f, n = _tag_assemble(arrived, wcols, nd, capacity)
        flats.append(f)
        counts.append(n)
    return flats, counts


def run_round_body(mesh: Mesh, src: Source, lo: int, capacity: int, axis,
                   exchange_mode="flat", dcn_axis=None, ici_axis=None,
                   coded_l_rows=None):
    """The flat / hierarchical / coded body dispatch shared by the
    exchange, the fused sort step and the multiround scatter. A coded
    dispatch without the plan's chunk length runs the plain staged body
    (the fused single-round step has no plan)."""
    if exchange_mode == "coded" and coded_l_rows:
        return coded_round_body(mesh, src, lo, dcn_axis, ici_axis,
                                capacity, int(coded_l_rows))
    if exchange_mode in ("hierarchical", "coded"):
        return hierarchical_round_body(mesh, src, lo, dcn_axis, ici_axis,
                                       capacity)
    return window_round_body(mesh, src, lo, axis, capacity)


def exchange_round(layout: ShuffleLayout, capacity: int,
                   round_index: int, coded_l_rows: Optional[int] = None):
    """One windowed exchange round (single-stage, the two-stage body when
    the layout resolved a pod topology, or the coded body when
    ``coded_l_rows`` carries the plan's chunk length).

    Returns ``(recv_words, recv_counts)``, lists over local slots:
    ``capacity`` rows from each peer (row block i = peer i's
    contribution, of which ``recv_counts[k][i]`` rows are valid)."""
    dispatch = layout.dispatch()
    if coded_l_rows:
        dispatch = dict(dispatch, exchange_mode="coded",
                        coded_l_rows=int(coded_l_rows))
    return run_round_body(layout.mesh, layout.source(),
                          round_index * capacity, capacity, layout.axis,
                          **dispatch)


def execute_planned_window(win, plan, coded_exec, plain_exec):
    """The ONE coded-window dispatch, shared by :func:`shuffle_exchange`
    and ``distributed.distributed_sort_multiround``: the decode-failure
    rung (failpoint ``exchange.decode``, keyed ``round<i>``, fired BEFORE
    the coded body runs, so the fallback dispatches an untouched window),
    ``coded_exec`` for plan-approved windows with in-round fallback to
    ``plain_exec`` on a decode failure (counted
    ``exchange.decode.fallbacks``), and the ledger of the body that
    actually ran."""
    from uda_tpu_torch.parallel.planner import record_executed_window

    if plan.coded and win.coded:
        decode_ok = True
        try:
            failpoint("exchange.decode", key=f"round{win.index}")
        except StorageError:
            metrics.add("exchange.decode.fallbacks")
            decode_ok = False
        if decode_ok:
            # outside the try by design: an error of the coded body itself
            # propagates (the fallback covers decode failures only)
            out = coded_exec()
            record_executed_window(win, plan, coded=True)
            return out
    out = plain_exec()
    record_executed_window(win, plan, coded=False)
    return out


def shuffle_exchange(words, dest, mesh: Mesh, axis, capacity: int,
                     max_rounds: Optional[int] = None,
                     mode: str = "auto"):
    """Full exchange: as many rounds as the largest (src, dst) bucket
    needs. Returns ``(per_round_results, layout)``, each round entry the
    ``(recv_words, recv_counts)`` pair of :func:`exchange_round`.

    The schedule is host-decided from one count-matrix readback: the
    planner derives every window, skips globally-empty ones
    (``exchange.rounds.skipped``) and records the per-axis accounting
    (``exchange.ici.bytes`` / ``exchange.dcn.bytes`` /
    ``exchange.dcn.messages``) of each executed round; with
    ``mode="coded"`` it decides per window whether the coded body runs,
    and coded windows book ``exchange.dcn.coded.bytes`` /
    ``exchange.dcn.saved.bytes``. More than ``max_rounds`` rounds raise
    ``TransportError`` before any round runs."""
    from uda_tpu_torch.parallel.planner import (plan_layout_rounds,
                                                record_plan_skips)

    layout = prepare_layout(words, dest, mesh, axis, mode)
    plan = plan_layout_rounds(layout, capacity)
    if max_rounds is not None and plan.planned > max_rounds:
        biggest = int(layout.counts.max()) if layout.counts.size else 0
        raise TransportError(
            f"skew needs {plan.planned} rounds (bucket {biggest} > "
            f"capacity {capacity} x {max_rounds}); raise capacity or "
            f"max_rounds")
    results = []
    for win in plan.windows:
        # injection site for exchange-plane faults (a failed collective
        # surfaces as TransportError)
        failpoint("exchange.round", key=f"round{win.index}")
        if layout.hierarchical:
            # the stage-resolved rung: a fault in the cross-pod DCN stage
            # (arm with match:stageB) surfaces like a whole-round failure
            failpoint("exchange.round", key=f"round{win.index}.stageB")
        results.append(execute_planned_window(
            win, plan,
            lambda: exchange_round(layout, capacity, win.index,
                                   plan.coded_l_rows),
            lambda: exchange_round(layout, capacity, win.index)))
    record_plan_skips(plan)
    return results, layout


def exchange_record_batches(batches_by_dest: Sequence[Sequence[RecordBatch]]
                            ) -> list[RecordBatch]:
    """Host-side variable-length exchange: ``batches_by_dest[src][dst]``
    -> per-dst concatenated batch (the byte-exact path for Hadoop
    records)."""
    ndst = max((len(row) for row in batches_by_dest), default=0)
    out = []
    for dst in range(ndst):
        out.append(RecordBatch.concat(
            [row[dst] for row in batches_by_dest if dst < len(row)]))
    return out
