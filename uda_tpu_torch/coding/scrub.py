"""Background stripe scrub: proactive verification (and optional
repair) of the k-of-n coded map-output layout (the port's copy of
``uda_tpu/coding/scrub.py``; its caller in the reference, the map phase of
``models/pipeline``, is not ported yet).

The coding layer's reconstruction only ever DECODES on demand — a shard lost
months before the fetch is discovered at reconstruction time, when it
may be the k-th loss. The scrub closes that window: a low-priority
pass re-derives each coded map output's parity from its data region
and checks every peer shard MOF against the bytes the placement rule
says it must hold, counting ``coding.scrub.stripes`` (partitions whose
stripe was verified) and ``coding.scrub.repairs`` (shards found lost
or corrupt). Dump-only by default — mismatches are counted and logged,
never written; ``uda.tpu.coding.scrub.repair`` lets the scrub REBUILD
a lost/corrupt peer shard from the primary's data+parity (the shard is
a pure function of them, so the rewrite is byte-exact).

Scheduling rides the ``tuncache.ensure_fresh`` idiom: ``maybe_scrub``
is a cheap, non-blocking kick any hot path may call — it starts at
most ONE daemon scrub per process and only when the configured
interval (``uda.tpu.coding.scrub.s``, 0 = off) has elapsed since the
last pass; a scrub failure is swallowed into ``errors.swallowed``
(the scrub is an insurance pass, never a job hazard).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

from uda_tpu_torch.coding import (domain_labels, parse_domains, parse_scheme,
                            rs, stripe_order)
from uda_tpu_torch.mofserver.index import read_index_file, shard_map_id
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["scrub_roots", "maybe_scrub", "scrub_state_reset"]

log = get_logger()


def _expected_shard_chunks(mof: bytes, recs, chunk: int) -> list[bytes]:
    """The bytes shard MOF ``<map>~s<chunk>`` must hold: per partition,
    data chunk ``chunk`` (a slice of the data region) or parity chunk
    ``chunk - k`` (a slice of the parity section)."""
    out = []
    for r in recs:
        st = r.stripe
        blob = mof[r.start_offset:r.start_offset + r.part_length]
        if chunk < st.k:
            out.append(rs.split_data(blob, st.k)[chunk])
        else:
            start, length = st.parity[chunk - st.k]
            out.append(mof[start:start + length])
    return out


def _rebuild_shard_atomic(sdir: str, chunk_bytes: list, full_parts: list
                          ) -> None:
    """Rewrite one shard MOF with rename-into-place semantics: a live
    supplier resolving the shard mid-repair reads either the old bytes
    or the new, never a torn file (``_write_shard`` writes in place —
    fine for the original fan-out, not for repairing a file something
    may be serving). Data lands before the index is replaced, so a
    reader that resolves through the new index finds the new bytes;
    the two renames are not one transaction — the residual window is
    index-new/data-new vs index-old/data-new, both self-consistent
    reads for the byte-range shard layout."""
    import shutil
    import tempfile

    from uda_tpu_torch.mofserver.writer import _write_shard

    tmp = tempfile.mkdtemp(prefix=".scrub_", dir=os.path.dirname(sdir)
                           or ".")
    try:
        _write_shard(tmp, chunk_bytes, full_parts)
        os.makedirs(sdir, exist_ok=True)
        os.replace(os.path.join(tmp, "file.out"),
                   os.path.join(sdir, "file.out"))
        os.replace(os.path.join(tmp, "file.out.index"),
                   os.path.join(sdir, "file.out.index"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def scrub_job_dir(roots: Sequence[str], primary_index: int,
                  job_id: str, map_id: str, repair: bool = False,
                  domains: Optional[dict] = None) -> dict:
    """Scrub ONE coded map output: parity section vs data region, and
    every peer shard's bytes vs the placement rule. Returns the report
    row; counts coding.scrub.stripes / coding.scrub.repairs."""
    d = os.path.join(roots[primary_index], job_id, map_id)
    recs = read_index_file(os.path.join(d, "file.out.index"),
                           os.path.join(d, "file.out"))
    row = {"map_id": map_id, "stripes": 0, "parity_mismatches": 0,
           "shard_faults": 0, "repaired": 0}
    if not recs or recs[0].stripe is None:
        return row           # uncoded map output: nothing to scrub
    with open(os.path.join(d, "file.out"), "rb") as f:
        mof = f.read()
    st = recs[0].stripe
    # 1. parity section vs data region (the primary's own health)
    for r in recs:
        blob = mof[r.start_offset:r.start_offset + r.part_length]
        want = rs.encode_parity(blob, r.stripe.k, r.stripe.n)
        got = [mof[s:s + ln] for s, ln in r.stripe.parity]
        row["stripes"] += 1
        metrics.add("coding.scrub.stripes")
        if got != want:
            row["parity_mismatches"] += 1
            log.warn(f"scrub: parity mismatch in {d} partition "
                     f"{r.start_offset} (stripe rs:{r.stripe.k}:"
                     f"{r.stripe.n})")
    if row["parity_mismatches"]:
        # an unhealthy PRIMARY must never drive the shard pass: the
        # expected-shard bytes derive from the primary's file.out, so
        # comparing (or worse, repairing) peer shards against corrupt
        # bytes would count every HEALTHY shard as a fault and — in
        # repair mode — overwrite the last good copies of the stripe
        # with the corruption. The primary's own recovery is the
        # reconstruction rung's job (any k of n shards); scrub only
        # reports it.
        log.warn(f"scrub: {d} parity mismatch — primary untrusted, "
                 f"shard checks/repair skipped for this map (rebuild "
                 f"the primary via reconstruction first)")
        return row
    # 2. peer shards vs the placement rule (domain_labels: the ONE
    # label derivation, including the namespace-miss warning)
    h = len(roots)
    order = stripe_order(h, primary_index, domain_labels(roots, domains))
    full_parts = [r.part_length for r in recs]
    for i in range(st.n):
        target = order[i % h]
        if target == primary_index:
            continue         # synthesized from file.out, no bytes
        sdir = os.path.join(roots[target], job_id,
                            shard_map_id(map_id, i))
        want_chunks = _expected_shard_chunks(mof, recs, i)
        ok = False
        try:
            srecs = read_index_file(os.path.join(sdir, "file.out.index"),
                                    os.path.join(sdir, "file.out"))
            with open(os.path.join(sdir, "file.out"), "rb") as f:
                smof = f.read()
            got_chunks = [smof[r.start_offset:r.start_offset
                               + r.part_length] for r in srecs]
            ok = got_chunks == want_chunks
        except Exception as e:  # noqa: BLE001 - a damaged
            # shard IS the finding; count below, never raise out of
            # the insurance pass
            log.debug(f"scrub: shard {sdir} unreadable: {e}")
        if not ok:
            row["shard_faults"] += 1
            metrics.add("coding.scrub.repairs")
            if repair:
                _rebuild_shard_atomic(sdir, want_chunks, full_parts)
                row["repaired"] += 1
                log.warn(f"scrub: rebuilt shard {sdir}")
            else:
                log.warn(f"scrub: shard {sdir} lost/corrupt "
                         f"(dump-only; set uda.tpu.coding.scrub."
                         f"repair to rebuild)")
    return row


def scrub_roots(roots: Sequence[str], repair: bool = False,
                domains: Optional[dict] = None,
                min_age_s: float = 0.0) -> dict:
    """Scrub every coded map output reachable under ``roots``: each
    root is scanned for ``<job>/<map>/file.out.index`` layouts; maps
    whose primary lives under root r are the ones whose full-stripe v2
    index sits there (shard pseudo-dirs are skipped — they are checked
    from their primary). ``min_age_s`` skips maps whose index was
    written within the last N seconds: the striped write lands the
    primary index BEFORE its peer shards (and neither write is
    atomic), so a background pass racing a live writer would book
    phantom shard faults — or, in repair mode, rewrite a shard the
    writer is still producing. ``roots`` are canonicalized (sorted
    unique — the placement order writer and reducer both derive,
    ``coding``) so shards are checked where the placement rule
    actually put them, whatever order the caller listed the roots in.
    Returns the aggregate report."""
    from uda_tpu_torch.mofserver.index import parse_shard_id

    roots = sorted(set(roots))
    report = {"maps": 0, "stripes": 0, "parity_mismatches": 0,
              "shard_faults": 0, "repaired": 0, "primary_faults": 0,
              "rows": []}
    now = time.time()
    for pi, root in enumerate(roots):
        if not os.path.isdir(root):
            continue
        for job_id in sorted(os.listdir(root)):
            jdir = os.path.join(root, job_id)
            if not os.path.isdir(jdir):
                continue
            for map_id in sorted(os.listdir(jdir)):
                if parse_shard_id(map_id) is not None:
                    continue     # a peer shard, checked via its primary
                idx = os.path.join(jdir, map_id, "file.out.index")
                if not os.path.exists(idx):
                    continue
                if min_age_s > 0:
                    try:
                        if now - os.path.getmtime(idx) < min_age_s:
                            continue   # possibly mid-write: next pass
                    except OSError:
                        continue       # vanished under us: next pass
                try:
                    row = scrub_job_dir(roots, pi, job_id, map_id,
                                        repair=repair, domains=domains)
                except Exception as e:  # noqa: BLE001 - a torn/lost
                    # PRIMARY is itself a finding, and one damaged map
                    # must never abort the pass over its neighbors
                    # (the peer-shard reads below already have this
                    # contract)
                    log.warn(f"scrub: primary map output "
                             f"{job_id}/{map_id} unreadable: {e}")
                    metrics.add("coding.scrub.repairs")
                    report["primary_faults"] = (
                        report.get("primary_faults", 0) + 1)
                    report["rows"].append({"map_id": map_id,
                                           "primary_fault": str(e)})
                    continue
                if row["stripes"]:
                    report["maps"] += 1
                    report["rows"].append(row)
                    for k in ("stripes", "parity_mismatches",
                              "shard_faults", "repaired"):
                        report[k] += row[k]
    return report


# -- the low-priority daemon rung (the tuncache.ensure_fresh idiom) ----------

_SCRUB_MU = threading.Lock()
_SCRUB_ACTIVE = False
# None = never ran (NOT monotonic 0.0: the monotonic epoch is
# unspecified — on a freshly booted host `now < interval` would
# otherwise suppress the first pass until uptime exceeds the interval)
_SCRUB_LAST: Optional[float] = None


def scrub_state_reset() -> None:
    """Test hygiene: forget the last-pass timestamp."""
    global _SCRUB_LAST
    with _SCRUB_MU:
        _SCRUB_LAST = None


def maybe_scrub(cfg, roots: Sequence[str]) -> bool:
    """Kick a background scrub when the interval has elapsed
    (``uda.tpu.coding.scrub.s``; 0 = off) and coding is configured.
    Non-blocking, at most one scrub in flight per process; the caller
    never learns the outcome (counters and logs do). Returns True when
    a pass was started."""
    global _SCRUB_ACTIVE, _SCRUB_LAST
    interval = int(cfg.get("uda.tpu.coding.scrub.s"))
    if interval <= 0 or parse_scheme(
            str(cfg.get("uda.tpu.coding.scheme"))) is None:
        return False
    repair = bool(cfg.get("uda.tpu.coding.scrub.repair"))
    domains = parse_domains(str(cfg.get("uda.tpu.coding.domains")))
    now = time.monotonic()
    with _SCRUB_MU:
        if _SCRUB_ACTIVE or (_SCRUB_LAST is not None
                             and now - _SCRUB_LAST < interval):
            return False
        _SCRUB_ACTIVE = True
        _SCRUB_LAST = now

    roots = list(roots)

    def _run() -> None:
        global _SCRUB_ACTIVE
        try:
            # a daemon pass never scrubs a map written in the last
            # minute — the striped write is not atomic and a live
            # writer's half-landed fan-out is not a fault
            rep = scrub_roots(roots, repair=repair, domains=domains,
                              min_age_s=min(60.0, float(interval)))
            if rep["shard_faults"] or rep["parity_mismatches"]:
                log.warn(f"stripe scrub: {rep['maps']} coded maps, "
                         f"{rep['parity_mismatches']} parity "
                         f"mismatches, {rep['shard_faults']} shard "
                         f"faults ({rep['repaired']} repaired)")
        except Exception as e:  # noqa: BLE001 - the scrub is an
            # insurance pass; a failure must never surface into the
            # data plane that kicked it
            metrics.add("errors.swallowed")
            log.warn(f"stripe scrub failed: {e}")
        finally:
            with _SCRUB_MU:
                _SCRUB_ACTIVE = False

    threading.Thread(target=_run, daemon=True,
                     name="uda-stripe-scrub").start()
    return True
