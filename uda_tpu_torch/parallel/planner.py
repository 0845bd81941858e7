"""Host-side round planner + per-axis (ICI/DCN) exchange accounting.

The port's copy of ``uda_tpu/parallel/planner.py`` (host numpy, as
there): the same plan, the same counters under the same names and labels.

The windowed exchange is *globally scheduled*: every device already
ships its per-(src, dst) bucket counts to the host (the one readback in
``prepare_layout``), so the host can decide — exactly, before any
collective runs — which windows move records at all and how many bytes
each fabric tier carries. This module is that decision plus its
evidence:

- :func:`plan_rounds` turns the ``[P, P]`` counts matrix into an
  ordered list of non-empty :class:`WindowPlan` s (globally-empty
  windows are skipped and counted — ``exchange.rounds.skipped``);
- each window carries the per-axis accounting the hierarchical
  exchange's win is proven with: ICI record bytes, DCN record bytes
  and the DCN **message** count — cross-pod (src, dst) *device* pairs
  for the flat single-stage exchange, coalesced *pod* pairs for the
  two-stage path (the reference's per-QP aggregation win,
  RDMAServer.cc chunked server pool);
- with ``coded=True`` the plan additionally decides, per window,
  whether the CODED stage-B path runs (the Coded TeraSort multicast
  discipline, arXiv:1702.04850): a pod pair is *codable* when its
  in-window cross rows spread over >= 2 destination chips and the
  padded multicast chunk (``L`` = the largest per-destination block,
  rounded up to :data:`CODED_CHUNK_ROWS` — the code's chunk
  granularity) at least halves the pair's payload
  (:data:`CODED_WIN_FACTOR`, the break-even guard). A window
  is coded only when EVERY pair with cross traffic is codable — mixed
  or skewed windows fall back to the plain coalesced tile with zero
  coded overhead, by plan;
- :func:`record_window_metrics` lands the numbers in
  ``exchange.ici.bytes`` / ``exchange.dcn.bytes`` /
  ``exchange.dcn.messages`` (DCN series labeled by source pod), plus
  — for coded windows — ``exchange.dcn.coded.bytes`` (the multicast
  charge, which IS the window's ``exchange.dcn.bytes``) and
  ``exchange.dcn.saved.bytes``, with the bookkeeping invariant
  ``coded + saved == uncoded payload`` per pair and in total.

Scope of the coded charge: the coded ledger books what a redundant-map Coded-TeraSort deployment moves over
the DCN — ONE multicast packet of ``L`` rows per pod pair serving all
``pod_size`` member reducers at once, their decode side information
being locally (re)computed from replicated map work. This virtual mesh
has no map redundancy to replicate, so the device tile ships the
full-rank coded chunk set (every member can decode every block) and
the side-information share of the tile rides the wire uncharged — the
gap between the model charge and the dense collective's wire footprint
is documented in parallel/exchange.py, exactly like
the dense-padding note the hierarchical ledger already carries.

The counts are *predictions* only in the sense that the host computes
them before the device program runs; they are exact — the round bodies
move precisely the in-window rows the counts matrix describes. They
count RECORD rows/bytes, i.e. the populated payload: the dense
all-to-all buffers of the staged body additionally
carry their unpopulated slots on the wire (see the scope note in
parallel/exchange.py) — the ledger here is the topology-invariant
payload measure the A/B gates compare, not the padded collective
footprint.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from uda_tpu_torch.parallel.mesh import MeshTopology
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["WindowPlan", "RoundPlan", "plan_rounds",
           "plan_layout_rounds", "record_window_metrics",
           "record_executed_window", "record_plan_skips",
           "CODED_CHUNK_ROWS"]

# the code's chunk granularity: a pair's multicast chunk length L is
# the largest per-destination block padded UP to this many rows (the
# rs.chunk_len discipline applied to rows instead of bytes), so the
# device tile shape quantizes and the charge stays honest about the
# pad. A pair only codes when the padded L still beats its payload.
CODED_CHUNK_ROWS = 4

# break-even guard: a pair codes only when the multicast chunk at
# least HALVES its payload (L_pad * FACTOR <= S). The k-fold cut
# presumes roughly balanced destination blocks; a skew-dominant block
# makes L ~ S and coding pure overhead — those pairs (and any window
# containing one) ride the plain coalesced tile.
CODED_WIN_FACTOR = 2


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One planned exchange window (round ``index`` moves each bucket's
    rows with in-bucket position in ``[index*capacity,
    (index+1)*capacity)``). Row counts are records, not bytes —
    multiply by the layout's record stride for bytes.

    ``dcn_rows``/``per_pod`` always hold the UNCODED payload figures
    (what the plain coalesced tile moves — and what a coded window
    books if its decode falls back mid-round); the ``coded*`` fields
    hold the multicast-model charges of the coded stage-B path and are
    meaningful only when ``coded`` is True."""

    index: int
    moved_rows: int       # in-window rows over all (src, dst) pairs
    ici_rows: int         # rows moved over intra-pod links (off-device;
    #                       hierarchical: staging hops included)
    dcn_rows: int         # rows crossing a pod boundary
    dcn_messages: int     # flat: cross-pod device pairs with traffic;
    #                       hierarchical: pod pairs with traffic
    per_pod: Tuple[Tuple[int, int, int], ...]  # (src pod, dcn rows,
    #                                             dcn messages)
    coded: bool = False   # this window runs the coded stage-B path
    l_rows: int = 0       # max padded chunk length over the window's
    #                       pairs (the device tile's static row count)
    coded_rows: int = 0   # multicast-model DCN charge (sum of L_pair)
    saved_rows: int = 0   # dcn_rows - coded_rows (>= 1 per coded pair)
    ici_rows_coded: int = 0  # ICI rows when the coded body runs (the
    #                       stage-C broadcast replaces the delivery
    #                       scatter: each coded chunk reaches every
    #                       member, the side-information trade)
    per_pod_coded: Tuple[Tuple[int, int, int], ...] = ()  # (src pod,
    #                       coded rows, saved rows)

    @property
    def empty(self) -> bool:
        return self.moved_rows == 0


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    windows: Tuple[WindowPlan, ...]   # the NON-empty windows, in order
    planned: int                      # windows considered (incl. empty)
    skipped: int                      # globally-empty windows dropped
    record_bytes: int
    hierarchical: bool
    coded: bool = False               # coded dispatch requested AND
    #                                   possible on this topology
    coded_l_rows: int = 0             # ONE static chunk length for the
    #                                   whole plan (max over coded
    #                                   windows: one compiled coded
    #                                   program per shuffle)


def _pod_vectors(n: int, topology: Optional[MeshTopology]):
    """(pod index, chip index) per device, or (None, None) when the
    mesh has no pod structure to account against."""
    if topology is None or topology.dcn_axis is None \
            or topology.num_pods <= 1:
        return None, None
    c = topology.pod_size
    dev = np.arange(n)
    return dev // c, dev % c


def _pad_chunk(rows: int) -> int:
    """Pad a block length up to the code's chunk granularity."""
    if rows <= 0:
        return 0
    return -(-rows // CODED_CHUNK_ROWS) * CODED_CHUNK_ROWS


def _plan_window_coding(inwin, topology):
    """The per-window coding decision over the in-window counts.

    Returns ``(coded, l_rows, per_pod_coded, extra_ici)`` — coded is
    True only when EVERY pod pair with cross traffic is codable
    (>= 2 destination chips AND the padded multicast chunk at least
    halves the pair's payload) and at least one such pair exists.
    ``extra_ici``
    is the stage-C broadcast cost of the coded body: every coded chunk
    reaches all ``pod_size`` members ((c-1) off-device copies of the
    c-chunk tile per pair) instead of the plain delivery scatter."""
    p, c = topology.num_pods, topology.pod_size
    if not topology.coded_capable:
        return False, 0, (), 0
    # per (src pod, dst pod, dst chip): in-window rows
    chip_mat = inwin.reshape(p, c, p, c).sum(axis=1)
    pair_rows = chip_mat.sum(axis=2)            # [src pod, dst pod]
    np.fill_diagonal(pair_rows, 0)
    if not pair_rows.any():
        return False, 0, (), 0
    l_rows = 0
    extra_ici = 0
    per_pod: dict[int, list[int]] = {}
    for g in range(p):
        for g2 in range(p):
            if g == g2 or pair_rows[g, g2] == 0:
                continue
            s = int(pair_rows[g, g2])
            k_eff = int((chip_mat[g, g2] > 0).sum())
            l_pad = _pad_chunk(int(chip_mat[g, g2].max()))
            if k_eff < 2 or l_pad * CODED_WIN_FACTOR > s:
                return False, 0, (), 0      # one uncodable pair ->
                # the whole window rides the plain coalesced tile
            l_rows = max(l_rows, l_pad)
            extra_ici += (c - 1) * c * l_pad
            cr, sv = per_pod.setdefault(g, [0, 0])
            per_pod[g] = [cr + l_pad, sv + (s - l_pad)]
    ppc = tuple((g, cr, sv) for g, (cr, sv) in sorted(per_pod.items()))
    return True, l_rows, ppc, extra_ici


def plan_rounds(counts, capacity: int,
                topology: Optional[MeshTopology] = None,
                record_bytes: int = 0,
                hierarchical: bool = False,
                coded: bool = False) -> RoundPlan:
    """Plan the windowed rounds for one exchange from its gathered
    counts matrix (``counts[src, dst]``, any integer dtype).

    Always plans at least one window (the flat exchange's historical
    ``max(1, ceil(max_bucket / capacity))`` round count) so an
    all-empty shuffle shows up as one *skipped* window rather than a
    silently-free exchange. A non-positive ``capacity`` raises — it
    would otherwise plan zero deliverable windows and silently drop
    the whole shuffle (the pre-planner code crashed on the division).

    On the skip's reach: in-bucket positions are contiguous from 0, so
    window ``r < ceil(max_bucket/capacity)`` always carries rows of at
    least the biggest bucket — with today's layouts the only reachable
    skip is the all-empty exchange (which previously EXECUTED one
    pointless all_to_all). The per-window check is kept general anyway:
    it is one subtraction on a tiny host matrix, and it guards any
    future planner input whose buckets are not contiguous (e.g. a
    pre-filtered or resumed counts matrix). What a *skewed* workload
    gains per round is the accounting — ``dcn_messages`` counts only
    pairs with real in-window traffic, so the near-empty tail rounds of
    a hot bucket report 1 pod-pair message, not a full fabric sweep."""
    if capacity <= 0:
        raise ValueError(f"exchange capacity must be positive, got "
                         f"{capacity}")
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0] if counts.ndim == 2 else 0
    coded = bool(coded) and bool(hierarchical) and topology is not None
    if hierarchical and n * capacity >= 1 << 31:
        # the staged body's delivery tag (src_device*capacity + slot)
        # is computed in int32 on device — past this it wraps and rows
        # silently misdeliver (the buffer is unbuildable long before,
        # but fail loudly, not by physics)
        raise ValueError(f"hierarchical exchange tag overflow: "
                         f"{n} devices x capacity {capacity} >= 2^31")
    biggest = int(counts.max()) if counts.size else 0
    total = max(1, -(-biggest // capacity))
    pod, chip = _pod_vectors(n, topology)
    if pod is not None:
        cross = pod[:, None] != pod[None, :]
        intra_off = (~cross) & ~np.eye(n, dtype=bool)
        if hierarchical:
            c = topology.pod_size
            # staging hops of the two-stage path: src chip -> egress
            # chip (stage A) and ingress chip -> dst chip (stage C);
            # the egress/ingress chip of pair (g, g') is
            # MeshTopology.egress_chip = (g + g') % pod_size
            egress = (pod[:, None] + pod[None, :]) % c
            hop_a = (chip[:, None] != egress).astype(np.int64)
            hops = hop_a + (egress != chip[None, :]).astype(np.int64)
    windows = []
    skipped = 0
    for r in range(total):
        inwin = np.clip(counts - r * capacity, 0, capacity) \
            if counts.size else np.zeros((0, 0), np.int64)
        moved = int(inwin.sum())
        if moved == 0:
            skipped += 1
            continue
        if pod is None:
            ici = int(inwin.sum() - np.trace(inwin))
            windows.append(WindowPlan(r, moved, ici, 0, 0, ()))
            continue
        if hierarchical:
            p = topology.num_pods
            pod_mat = inwin.reshape(p, topology.pod_size, p,
                                    topology.pod_size).sum(axis=(1, 3))
            off = pod_mat - np.diag(np.diag(pod_mat))
            dcn_rows = int(off.sum())
            msgs_mat = (off > 0).astype(np.int64)
            ici = (int(inwin[intra_off].sum())
                   + int((inwin * hops)[cross].sum()))
            per_pod = tuple(
                (g, int(off[g].sum()), int(msgs_mat[g].sum()))
                for g in range(p) if off[g].sum() or msgs_mat[g].sum())
            win_coded, l_win, ppc, extra_ici = (
                _plan_window_coding(inwin, topology) if coded
                else (False, 0, (), 0))
            ici_coded = 0
            if win_coded:
                # the coded body keeps stage A's egress staging hop
                # but replaces the stage-C delivery scatter with the
                # chunk broadcast (extra_ici): intra + hop A + bcast
                ici_coded = (int(inwin[intra_off].sum())
                             + int((inwin * hop_a)[cross].sum())
                             + extra_ici)
            windows.append(WindowPlan(
                r, moved, ici, dcn_rows, int(msgs_mat.sum()), per_pod,
                coded=win_coded, l_rows=l_win,
                coded_rows=sum(cr for _, cr, _ in ppc),
                saved_rows=sum(sv for _, _, sv in ppc),
                ici_rows_coded=ici_coded, per_pod_coded=ppc))
        else:
            dcn_rows = int(inwin[cross].sum())
            msgs = (inwin > 0) & cross
            per_pod = []
            for g in range(topology.num_pods):
                sel = pod == g
                rows_g = int(inwin[sel][cross[sel]].sum())
                msgs_g = int(msgs[sel].sum())
                if rows_g or msgs_g:
                    per_pod.append((g, rows_g, msgs_g))
            windows.append(WindowPlan(
                r, moved, int(inwin[intra_off].sum()), dcn_rows,
                int(msgs.sum()), tuple(per_pod)))
    l_plan = max((w.l_rows for w in windows if w.coded), default=0)
    return RoundPlan(tuple(windows), total, skipped, int(record_bytes),
                     bool(hierarchical), coded=coded,
                     coded_l_rows=l_plan)


def plan_layout_rounds(layout, capacity: int) -> RoundPlan:
    """Plan one prepared ``ShuffleLayout``'s windows — the single
    layout->planner wiring (counts matrix, topology, resolved dispatch,
    record stride) shared by ``exchange.shuffle_exchange`` and
    ``distributed.distributed_sort_multiround``."""
    return plan_rounds(layout.counts, capacity, layout.topology,
                       layout.record_bytes(), layout.hierarchical,
                       coded=getattr(layout, "coded", False))


def record_executed_window(win: WindowPlan, plan: RoundPlan,
                           coded: bool = False) -> None:
    """Account one executed window: the round counter plus its per-axis
    fabric metrics (one call site contract for every round loop).
    ``coded`` says which body ACTUALLY ran — a coded window whose
    decode fell back mid-round books the plain-tile figures."""
    metrics.add("exchange.rounds")
    record_window_metrics(win, plan.record_bytes, coded=coded)


def record_plan_skips(plan: RoundPlan) -> None:
    if plan.skipped:
        metrics.add("exchange.rounds.skipped", plan.skipped)


def record_window_metrics(win: WindowPlan, record_bytes: int,
                          coded: bool = False) -> None:
    """Land one executed window's per-axis accounting in the metrics
    hub. The DCN series carry a source-pod label (the labeled-counter
    machinery advances the unlabeled totals too). A CODED window books
    the multicast charge as its ``exchange.dcn.bytes`` plus the coded/
    saved breakdown — ``coded + saved == the plain window's payload``
    by construction (the ledger-sum invariant the tests pin)."""
    if coded and win.coded:
        if win.ici_rows_coded:
            metrics.add("exchange.ici.bytes",
                        win.ici_rows_coded * record_bytes)
        for g, crows, srows in win.per_pod_coded:
            if crows:
                metrics.add("exchange.dcn.bytes", crows * record_bytes,
                            pod=g)
                metrics.add("exchange.dcn.coded.bytes",
                            crows * record_bytes, pod=g)
            if srows:
                metrics.add("exchange.dcn.saved.bytes",
                            srows * record_bytes, pod=g)
        for g, _rows, msgs in win.per_pod:
            if msgs:
                metrics.add("exchange.dcn.messages", msgs, pod=g)
        return
    if win.ici_rows:
        metrics.add("exchange.ici.bytes", win.ici_rows * record_bytes)
    for g, rows, msgs in win.per_pod:
        if rows:
            metrics.add("exchange.dcn.bytes", rows * record_bytes,
                        pod=g)
        if msgs:
            metrics.add("exchange.dcn.messages", msgs, pod=g)
