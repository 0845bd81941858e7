"""udatop: a live per-supplier console over the MSG_STATS plane.

Polls a list of shuffle endpoints (``host[:port]``) with the wire's
uncredited MSG_STATS snapshot request (uda_tpu_torch/net/wire.py) and
renders one line per supplier: connections, in-flight serves, serve
throughput (delta of ``net.bytes.out{role=server}`` between polls),
read-latency p95, penalties, ResourceLedger obligations/leaks: the
operator's top(1). The port's counterpart of ``scripts/udatop.py``, with
its flags, table, statuses and ``--json`` document; it polls either
package's servers (the frames are the same).

Usage::

    python -m uda_tpu_torch.tools.udatop host1 host2:9012 --interval 2
    python -m uda_tpu_torch.tools.udatop 127.0.0.1:9012 --once --json

``--once`` prints a single sample and exits (scriptable; ``--json``
dumps the raw snapshots instead of the table). A peer that refuses
MSG_STATS (old version: typed ERR or disconnect) renders as
``unsupported``; an unreachable one as ``down`` — the console never
crashes over one sick supplier.

``--window N`` asks each CAP_OBS peer for its observability sections
(time-series rollups for the trailing N seconds, per-tenant SLIs,
active anomalies): tenanted peers grow per-tenant sub-rows (scheduled
share vs entitlement, worst SLO burn rate, starvation streak) and an
``anomalies:`` line. A pre-observability peer simply renders the
plain table — never ``unsupported``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from uda_tpu_torch.net.client import fetch_remote_stats
from uda_tpu_torch.utils.config import Config
from uda_tpu_torch.utils.errors import TransportError, UdaError

_HEADER = (f"{'supplier':<22} {'gen':>5} {'conns':>5} {'onair':>5} "
           f"{'MB/s':>8} {'read p95':>9} {'penal':>5} {'oblig':>5} "
           f"{'leaks':>5} {'where':<16}")


def where_time_goes(prov: dict) -> str:
    """The dominant time-accounting bucket from the peer's
    ``time_accounting`` stats provider (uda_tpu_torch.utils.critpath rides
    MSG_STATS), e.g. ``merge 62%`` — '-' when the peer records no
    spans or predates the provider."""
    ta = prov.get("time_accounting") if isinstance(prov, dict) else None
    if not isinstance(ta, dict):
        return "-"
    buckets = ta.get("buckets")
    if not isinstance(buckets, dict) or not buckets:
        return "-"
    best = max(buckets.items(),
               key=lambda kv: kv[1].get("critical_s", 0.0))
    if best[1].get("critical_s", 0.0) <= 0:
        return "-"
    return f"{best[0]} {best[1].get('share', 0.0) * 100:.0f}%"


def parse_host(spec: str, default_port: int):
    host, _, port = spec.partition(":")
    return host or "127.0.0.1", int(port) if port else default_port


def worst_burn(tslo: dict) -> tuple:
    """(burn, sli name) of the tenant's hottest SLO, ('-', '-') when
    nothing is judged yet."""
    best = None
    for sli, block in (tslo or {}).items():
        burn = block.get("burn") if isinstance(block, dict) else None
        if burn is None:
            continue
        if best is None or burn > best[0]:
            best = (burn, sli)
    return best if best else ("-", "-")


def tenant_rows(snap: dict) -> list:
    """Per-tenant sub-rows from a CAP_OBS peer's ``sli`` block (empty
    for untenanted or pre-observability peers)."""
    sli = snap.get("sli")
    if not isinstance(sli, dict) or not sli.get("tenants"):
        return []
    lines = []
    for t, blk in sli["tenants"].items():
        share = blk.get("window_share")
        entitled = blk.get("entitled")
        burn, burn_sli = worst_burn(blk.get("slo"))
        share_txt = (f"{share * 100:5.1f}%" if share is not None
                     else "    -")
        tail = (f" of {entitled * 100:5.1f}% entitled"
                if entitled else "")
        burn_txt = (f"  burn {burn:g} ({burn_sli})"
                    if burn != "-" else "  burn -")
        starve = blk.get("starve_streak_s") or 0
        lines.append(f"  └ {t:<19} share {share_txt}{tail}"
                     f"{burn_txt}"
                     + (f"  STARVED {starve:g}s" if starve else ""))
    anomalies = snap.get("anomalies")
    if isinstance(anomalies, dict) and anomalies.get("active"):
        kinds = ", ".join(f"{a['kind']}({a['key']})"
                          for a in anomalies["active"])
        lines.append(f"  ! anomalies: {kinds}")
    return lines


def row(spec: str, snap, prev, dt: float) -> str:
    if isinstance(snap, str):  # "down" / "unsupported"
        return f"{spec:<22} {snap}"
    c = snap.get("counters", {})
    g = snap.get("gauges", {})
    p = snap.get("percentiles", {})
    led = snap.get("resledger", {})
    prov = snap.get("providers", {})
    srv = prov.get("net.server", {}) if isinstance(prov, dict) else {}
    out_now = c.get("net.bytes.out{role=server}", 0.0)
    out_prev = (prev.get("counters", {})
                .get("net.bytes.out{role=server}", 0.0)
                if isinstance(prev, dict) else None)
    mb_s = ((out_now - out_prev) / dt / 1e6
            if out_prev is not None and dt > 0 else 0.0)
    p95 = p.get("supplier.read.latency_ms", {}).get("p95", 0.0)
    return (f"{spec:<22} {srv.get('generation', '?'):>5} "
            f"{int(g.get('net.server.connections', 0)):>5} "
            f"{int(g.get('net.server.inflight', 0)):>5} "
            f"{mb_s:>8.2f} {p95:>8.1f}ms "
            f"{int(c.get('fetch.penalties', 0)):>5} "
            f"{led.get('outstanding', 0):>5} "
            f"{led.get('leak_reports', 0):>5} "
            f"{where_time_goes(prov):<16}")


def poll(targets, timeout: float, window_s=None):
    snaps = {}
    for spec, (host, port) in targets.items():
        try:
            snaps[spec] = fetch_remote_stats(host, port, timeout=timeout,
                                             window_s=window_s)
        except UdaError as e:
            # a typed refusal (ProtocolError from an old peer) vs a
            # dead endpoint — branch on the exception TYPE, never its
            # message (UDA005)
            snaps[spec] = ("down" if isinstance(e, TransportError)
                           else "unsupported")
    return snaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("hosts", nargs="+", help="supplier endpoints, "
                                             "host[:port]")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="one sample, no screen clearing")
    ap.add_argument("--json", action="store_true",
                    help="dump raw snapshots as JSON (implies no table)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--window", type=int, default=None, metavar="S",
                    help="request CAP_OBS observability sections for "
                         "the trailing S seconds (per-tenant SLI "
                         "sub-rows + anomalies; old peers degrade to "
                         "the plain table)")
    args = ap.parse_args(argv)
    default_port = int(Config().get("uda.tpu.net.port"))
    targets = {spec: parse_host(spec, default_port)
               for spec in args.hosts}
    prev: dict = {}
    prev_t = time.monotonic()
    while True:
        snaps = poll(targets, args.timeout, window_s=args.window)
        now = time.monotonic()
        dt = max(now - prev_t, 1e-9)
        if args.json:
            print(json.dumps({spec: s if isinstance(s, dict) else
                              {"status": s} for spec, s in snaps.items()},
                             default=repr))
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(time.strftime("%H:%M:%S"), "udatop —",
                  len(targets), "supplier(s), every",
                  f"{args.interval:g}s")
            print(_HEADER)
            for spec in args.hosts:
                print(row(spec, snaps[spec], prev.get(spec), dt))
                if isinstance(snaps[spec], dict):
                    for line in tenant_rows(snaps[spec]):
                        print(line)
            sys.stdout.flush()
        if args.once:
            return 0
        prev, prev_t = snaps, now
        time.sleep(args.interval)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        sys.exit(0)
