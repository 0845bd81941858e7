"""udafleet: fleet-wide aggregation over the CAP_OBS stats plane.

Polls MANY shuffle daemons (``host[:port]`` each) with the windowed
MSG_STATS request (uda_tpu_torch/net/wire.py ``_STATS_OPT`` tail) and merges
the per-daemon observability sections into ONE fleet view:

- **throughput** — fleet-total fetch/serve byte rates from each
  daemon's time-series window (sum of per-interval byte deltas over
  the wall-clock the window spans);
- **tenants** — each tenant's scheduled bytes and window share summed
  ACROSS daemons (a tenant squeezed on one daemon but overfed on
  another nets out here — the per-daemon SLI book cannot see that),
  worst SLO attainment/burn anywhere in the fleet, and the daemons on
  which it is currently starving;
- **anomalies** — every active anomaly in the fleet, labeled with the
  daemon that raised it;
- **daemons** — per-endpoint status: ``ok`` / ``down`` (unreachable:
  TransportError) / ``unsupported`` (pre-MSG_STATS peer:
  ProtocolError) / ``plain`` (answers MSG_STATS but predates CAP_OBS
  — the sections are absent, the daemon still counts as up).

Usage::

    python -m uda_tpu_torch.tools.udafleet host1 host2:9012 --window 60 \
        --once --json
    python -m uda_tpu_torch.tools.udafleet $(cat fleet.txt) --interval 5

``--once --json`` prints one merged fleet document and exits (the
scriptable surface). The console never crashes over one sick daemon
(UDA005: down-vs-unsupported branches on exception TYPE). The port's
counterpart of ``scripts/udafleet.py``: the same merge and document, over
either package's daemons.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from uda_tpu_torch.net.client import fetch_remote_stats
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import (ProtocolError, TransportError,
                                        UdaError)


def parse_host(spec: str, default_port: int):
    host, _, port = spec.partition(":")
    return host or "127.0.0.1", int(port) if port else default_port


def poll(targets, timeout: float, window_s: int):
    """{spec: snapshot dict | "down" | "unsupported"} — one windowed
    poll per daemon, typed-degradation contract as udatop."""
    snaps = {}
    for spec, (host, port) in targets.items():
        try:
            snaps[spec] = fetch_remote_stats(host, port, timeout=timeout,
                                             window_s=window_s)
        except TransportError:
            snaps[spec] = "down"
        except (ProtocolError, UdaError):
            # a typed refusal (old peer) — up, but not speaking
            # MSG_STATS; vs "down" above on the TYPE (UDA005)
            snaps[spec] = "unsupported"
    return snaps


def _window_byte_rate(ts_block: dict, counter: str) -> float:
    """Sum of a counter's per-interval deltas across the daemon's
    returned window, over the wall-clock the window spans — the
    daemon's trailing-window byte rate (0.0 when the window is empty
    or the counter never moved)."""
    rolls = ts_block.get("rollups") or []
    total = 0.0
    span = 0.0
    for roll in rolls:
        span += roll.get("dt", 0.0)
        total += (roll.get("counters") or {}).get(counter, 0.0)
    return total / span if span > 0 else 0.0


def merge(snaps: dict) -> dict:
    """The fleet document: per-daemon sections folded into one view."""
    fleet = {
        "ts": round(time.time(), 3),
        "daemons": {},
        "throughput": {"fetch_mb_s": 0.0, "serve_mb_s": 0.0},
        "tenants": {},
        "anomalies": [],
    }
    sched_total = 0.0
    for spec, snap in sorted(snaps.items()):
        if isinstance(snap, str):
            fleet["daemons"][spec] = snap
            continue
        has_obs = isinstance(snap.get("timeseries"), dict)
        fleet["daemons"][spec] = "ok" if has_obs else "plain"
        if not has_obs:
            continue
        ts_block = snap["timeseries"]
        fleet["throughput"]["fetch_mb_s"] += round(
            _window_byte_rate(ts_block, "fetch.bytes") / 1e6, 3)
        fleet["throughput"]["serve_mb_s"] += round(
            _window_byte_rate(ts_block, "supplier.bytes") / 1e6, 3)
        sli = snap.get("sli")
        if isinstance(sli, dict):
            for t, blk in (sli.get("tenants") or {}).items():
                agg = fleet["tenants"].setdefault(t, {
                    "sched_bytes": 0, "daemons": 0,
                    "worst_attainment": None, "worst_burn": None,
                    "worst_burn_sli": None, "starving_on": []})
                agg["daemons"] += 1
                agg["sched_bytes"] += int(blk.get("sched_bytes") or 0)
                sched_total += blk.get("sched_bytes") or 0
                if blk.get("starve_streak_s"):
                    agg["starving_on"].append(spec)
                for sli_name, s in (blk.get("slo") or {}).items():
                    att, burn = s.get("attainment"), s.get("burn")
                    if att is not None and (
                            agg["worst_attainment"] is None
                            or att < agg["worst_attainment"]):
                        agg["worst_attainment"] = att
                    if burn is not None and (
                            agg["worst_burn"] is None
                            or burn > agg["worst_burn"]):
                        agg["worst_burn"] = burn
                        agg["worst_burn_sli"] = sli_name
        anomalies = snap.get("anomalies")
        if isinstance(anomalies, dict):
            for a in anomalies.get("active") or []:
                fleet["anomalies"].append(dict(a, daemon=spec))
    # fleet-wide share: each tenant's scheduled bytes over every
    # tenant's, ACROSS daemons — the number no single daemon can
    # compute locally
    for agg in fleet["tenants"].values():
        agg["fleet_share"] = (round(agg["sched_bytes"] / sched_total, 4)
                              if sched_total else None)
    fleet["throughput"]["fetch_mb_s"] = round(
        fleet["throughput"]["fetch_mb_s"], 3)
    fleet["throughput"]["serve_mb_s"] = round(
        fleet["throughput"]["serve_mb_s"], 3)
    return fleet


def render(fleet: dict) -> None:
    up = sum(1 for s in fleet["daemons"].values() if s in ("ok", "plain"))
    print(time.strftime("%H:%M:%S"), "udafleet —",
          f"{up}/{len(fleet['daemons'])} daemons up,",
          f"fetch {fleet['throughput']['fetch_mb_s']:g} MB/s,",
          f"serve {fleet['throughput']['serve_mb_s']:g} MB/s")
    for spec, status in fleet["daemons"].items():
        if status != "ok":
            print(f"  {spec:<22} {status}")
    if fleet["tenants"]:
        print(f"  {'tenant':<20} {'share':>7} {'sched MB':>9} "
              f"{'worst att':>9} {'burn':>6}  starving on")
        for t, agg in sorted(fleet["tenants"].items()):
            share = (f"{agg['fleet_share'] * 100:6.1f}%"
                     if agg["fleet_share"] is not None else "      -")
            att = (f"{agg['worst_attainment']:9.4f}"
                   if agg["worst_attainment"] is not None else "        -")
            burn = (f"{agg['worst_burn']:6g}"
                    if agg["worst_burn"] is not None else "     -")
            starving = ",".join(agg["starving_on"]) or "-"
            print(f"  {t:<20} {share} "
                  f"{agg['sched_bytes'] / 1e6:9.1f} {att} {burn}  "
                  f"{starving}")
    for a in fleet["anomalies"]:
        print(f"  ! {a.get('kind')}({a.get('key')}) on {a.get('daemon')}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("hosts", nargs="+",
                    help="daemon endpoints, host[:port]")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--window", type=int, default=60, metavar="S",
                    help="trailing time-series window to request")
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print the merged fleet document as JSON")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    default_port = int(Config().get("uda.tpu.net.port"))
    targets = {spec: parse_host(spec, default_port)
               for spec in args.hosts}
    while True:
        fleet = merge(poll(targets, args.timeout, args.window))
        if args.json:
            print(json.dumps(fleet, default=repr))
        else:
            render(fleet)
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(0)
