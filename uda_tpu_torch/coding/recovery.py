"""k-of-n stripe reconstruction: the post-retry rung of the fetch
ladder (the port's copy of ``uda_tpu/coding/recovery.py``).

When a Segment has exhausted transport retries against its primary
supplier (dead host, poisoned penalty box), this module rebuilds the
partition's on-disk bytes from ANY k of the stripe's n chunks: it
fans shard fetches (``<map_id>~s<i>`` pseudo-maps) out over the
ordinary InputClient — so shards ride the same routing, wire, retry
and zero-copy machinery as data — collects the first k complete
chunks, and Reed-Solomon-decodes them (``coding/rs``) into one
full-partition FetchResult (offset 0, last=True).

Source choice shares the task's recovery ledger: candidates are
ordered non-primary first (the primary just proved itself dead), then
by PenaltyBox rank, then data chunks before parity (systematic chunks
decode by concatenation). A failed shard stream promotes the next
candidate; the reconstruction fails only when fewer than k of the n
chunks are reachable at all.

Everything here is completion-driven (no blocking waits): shard
fetches chain from transport callbacks exactly like Segment's drive
loop, so a reconstruction is safe to start from a completion thread.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional, Sequence

from uda_tpu_torch.coding import rs, stripe_host
from uda_tpu_torch.mofserver.index import shard_map_id
from uda_tpu_torch.utils.errors import StorageError, attribute_supplier
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["StripeContext", "start_recovery"]

log = get_logger()


class StripeContext:
    """Everything the reconstruction needs that the failing request
    does not carry: the coding scheme, the job's canonically-ordered
    supplier list (the placement universe — sorted unique hosts), the
    declared failure-domain map (``uda.tpu.coding.domains``; empty =
    positional rotation), and the task's recovery ledger for source
    ranking/accounting."""

    def __init__(self, scheme, suppliers: Sequence[str], ledger=None,
                 domains=None):
        self.scheme = scheme
        self.suppliers = list(suppliers)
        self.ledger = ledger
        self.domains = dict(domains or {})
        # per-primary placement cache: the permutation depends only on
        # (suppliers, domains, primary), and host_of runs once per
        # CHUNK on the reconstruction hot path — rebuilding the
        # domain-interleave per chunk would be O(h) each
        self._orders: dict = {}

    def host_of(self, primary: str, chunk: int) -> str:
        order = self._orders.get(primary)
        if order is None:
            order = self._orders[primary] = [
                stripe_host(self.suppliers, primary, c,
                            domains=self.domains)
                for c in range(max(1, len(self.suppliers)))]
        return order[chunk % len(order)]


def start_recovery(client, req, ctx: StripeContext,
                   on_complete: Callable) -> None:
    """Reconstruct ``req``'s partition; ``on_complete`` receives a
    full-partition FetchResult or an Exception. ``client`` serves the
    shard fetches (its ``start_fetch``); ``req.host`` names the failed
    primary."""
    _Reconstruction(client, req, ctx, on_complete).start()


class _Reconstruction:
    def __init__(self, client, req, ctx: StripeContext, on_complete):
        from uda_tpu_torch.mofserver.data_engine import FetchResult

        self._result_cls = FetchResult
        self.client = client
        self.req = req
        self.ctx = ctx
        self.on_complete = on_complete
        self.k = ctx.scheme.k
        self.n = ctx.scheme.n
        self._lock = threading.Lock()
        # span attribution: the reconstruction starts under the owning
        # segment's ``coding_recover`` span (``Segment._try_recover``);
        # capture it here, because every later shard issue and the decode
        # run on completion threads
        self.parent_span = metrics.current_span()
        # chunks grouped by their reported stripe identity (the
        # full-partition length): a STALE shard from a prior map
        # attempt lands in its own group instead of poisoning the
        # fresh one — whichever identity first collects k chunks wins
        self._groups: dict[int, dict[int, bytes]] = {}
        self._active = 0
        self._finished = False
        self._last_error: Optional[Exception] = None
        ranked = self._rank_candidates()
        self._pending: deque = deque(ranked)

    def _rank_candidates(self) -> list[tuple[int, str]]:
        cands = [(i, self.ctx.host_of(self.req.host, i))
                 for i in range(self.n)]
        hosts = []
        for _, h in cands:
            if h not in hosts:
                hosts.append(h)
        ledger = self.ctx.ledger
        order = {h: r for r, h in enumerate(
            ledger.rank(hosts) if ledger is not None else hosts)}
        cands.sort(key=lambda c: (c[1] == self.req.host,
                                  order.get(c[1], 0), c[0] >= self.k,
                                  c[0]))
        return cands

    # -- stream scheduling ---------------------------------------------------

    def start(self) -> None:
        self._launch()

    def _best_group(self) -> dict:
        return max(self._groups.values(), key=len) if self._groups \
            else {}

    def _launch(self) -> None:
        """Start shard streams until k are in flight or collected.
        Issues outside the lock (a dial may block)."""
        while True:
            with self._lock:
                if self._finished:
                    return
                need = self.k - len(self._best_group()) - self._active
                if need <= 0 or not self._pending:
                    exhausted = (need > 0 and self._active == 0
                                 and not self._pending)
                    break
                idx, host = self._pending.popleft()
                self._active += 1
            _ShardStream(self, idx, host).issue(0)
        if exhausted:
            have = sorted(self._best_group())
            err = StorageError(
                f"stripe of {self.req.map_id}/{self.req.reduce_id} "
                f"unrecoverable: {len(have)}/{self.k} chunks reachable "
                f"(have {have}; last shard error: {self._last_error})")
            attribute_supplier(err, self.req.host)
            self._finish(err)

    def _stream_done(self, idx: int, host: str, data: bytes,
                     full_part: int) -> None:
        with self._lock:
            if self._finished:
                return
            self._active -= 1
            # group by stripe identity: shards of a DIFFERENT map
            # attempt (different full-partition length) collect
            # separately — mixing them would decode garbage, and
            # letting the FIRST arrival define the baseline would let
            # one stale shard poison k fresh ones
            group = self._groups.setdefault(full_part, {})
            group[idx] = data
            decode = len(group) >= self.k
        ledger = self.ctx.ledger
        if ledger is not None:
            ledger.record("shard_fetched", supplier=host,
                          map_id=self.req.map_id)
        metrics.add("coding.shard.fetches", supplier=host)
        if decode:
            self._decode(full_part)
        else:
            self._launch()

    def _stream_failed(self, idx: int, host: str, exc: Exception) -> None:
        with self._lock:
            if self._finished:
                return
            self._active -= 1
            self._last_error = exc
        metrics.add("coding.shard.failures", supplier=host)
        ledger = self.ctx.ledger
        if ledger is not None:
            ledger.record("shard_failed", supplier=host,
                          map_id=self.req.map_id, error=exc)
        log.warn(f"stripe shard {idx} of {self.req.map_id} from "
                 f"{host or 'local'} failed ({exc}); trying the next "
                 f"candidate")
        self._launch()

    # -- decode + delivery ---------------------------------------------------

    def _decode(self, full_part: int) -> None:
        with self._lock:
            if self._finished:
                return
            chunks = dict(self._groups.get(full_part, {}))
        try:
            failpoint("coding.decode",
                      key=f"{self.req.map_id}/{self.req.reduce_id}")
            with metrics.timer("coding_decode", parent=self.parent_span):
                blob = rs.decode(chunks, self.k, self.n, full_part)
        except Exception as e:  # noqa: BLE001 - decode failure is the
            # reconstruction's terminal error; surfaced to the segment
            attribute_supplier(e, self.req.host)
            self._finish(e)
            return
        metrics.add("coding.reconstructed.partitions")
        metrics.add("coding.reconstructed.bytes", len(blob))
        ledger = self.ctx.ledger
        if ledger is not None:
            ledger.record("reconstructed", supplier=self.req.host,
                          map_id=self.req.map_id)
        log.warn(f"reconstructed {self.req.map_id}/{self.req.reduce_id} "
                 f"({len(blob)} B) from {sorted(chunks)} of "
                 f"{self.n} stripe chunks (k={self.k})")
        self._finish(self._result_cls(
            blob, len(blob), len(blob), 0,
            f"rs://{self.req.map_id}/{self.req.reduce_id}", last=True))

    def _finish(self, result) -> None:
        with self._lock:
            if self._finished:
                return
            self._finished = True
        self.on_complete(result)


class _ShardStream:
    """One shard's sequential chunk-fetch chain (offset loop until
    ``last``), iterative like Segment._drive: an inline completion is
    handed back to the issuing frame instead of recursing."""

    _PENDING = object()

    def __init__(self, rec: _Reconstruction, idx: int, host: str):
        self.rec = rec
        self.idx = idx
        self.host = host
        self.map_id = shard_map_id(rec.req.map_id, idx)
        self.buf = bytearray()
        self.full_part: Optional[int] = None
        self._mu = threading.Lock()
        self._issuing = False
        self._inline = self._PENDING

    def issue(self, offset: int) -> None:
        from uda_tpu_torch.mofserver.data_engine import ShuffleRequest

        result = self._PENDING
        while True:
            req = ShuffleRequest(self.rec.req.job_id, self.map_id,
                                 self.rec.req.reduce_id, offset,
                                 self.rec.req.chunk_size, host=self.host)
            with self._mu:
                self._issuing = True
                self._inline = self._PENDING
            try:
                # adopt the owning fetch span for this issue: shard streams
                # chain from completion threads, so the explicit parent is
                # how their transport spans join the segment's trace tree
                with metrics.use_span(self.rec.parent_span):
                    self.rec.client.start_fetch(req, self._on_complete)
            except Exception as e:  # noqa: BLE001 - sync transport
                # raise == failed stream, same as an error completion
                with self._mu:
                    self._issuing = False
                self.rec._stream_failed(self.idx, self.host, e)
                return
            with self._mu:
                self._issuing = False
                result = self._inline
                self._inline = self._PENDING
            if result is self._PENDING:
                return  # async: _on_complete drives the next step
            offset = self._step(result)
            if offset is None:
                return
            result = self._PENDING

    def _on_complete(self, result) -> None:
        with self._mu:
            if self._issuing:
                self._inline = result
                return
        offset = self._step(result)
        if offset is not None:
            self.issue(offset)

    def _step(self, result) -> Optional[int]:
        """Absorb one completion; returns the next offset to fetch or
        None when the stream ended (complete or failed)."""
        if isinstance(result, Exception):
            self.rec._stream_failed(self.idx, self.host, result)
            return None
        crc = getattr(result, "crc", None)
        if crc is not None:
            import zlib

            if zlib.crc32(result.data) & 0xFFFFFFFF != crc:
                self.rec._stream_failed(self.idx, self.host, StorageError(
                    f"shard chunk CRC mismatch at {self.map_id}:"
                    f"{result.offset}"))
                return None
        self.full_part = result.raw_length  # the decode-trim total
        self.buf += result.data
        if result.is_last:
            self.rec._stream_done(self.idx, self.host, bytes(self.buf),
                                  self.full_part)
            return None
        return result.offset + len(result.data)
