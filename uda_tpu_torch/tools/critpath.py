"""critpath: offline time-accounting over exported span JSONL files.

The standalone face of ``uda_tpu_torch.utils.critpath`` (the port's
counterpart of ``scripts/critpath.py``): point it at one or
more ``metrics.export_spans_jsonl`` files (the same inputs
``scripts/trace_merge.py`` stitches) and it prints where the wall-clock
went — the per-bucket critical/busy partition, overlap factors and the
longest dependency chain — without needing the process that recorded
them.

Usage::

    python -m uda_tpu_torch.tools.critpath spans.jsonl [more.jsonl ...]
        [--root reduce_task] [--json]

Exit codes: 0 ok; 2 usage/IO; 3 no analyzable spans. ``--json`` dumps
the raw ``time_accounting`` block (the exact shape the StatsReporter
final record and MSG_STATS carry); default output is a human table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from uda_tpu_torch.utils.critpath import analyze


def load(paths):
    spans = []
    missing_anchor = set()
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    raise SystemExit(f"critpath: {path}:{lineno}: bad "
                                     f"span record: {e}")
                # cross-process comparability: raw "ts" is seconds
                # since that PROCESS's arbitrary perf_counter epoch —
                # stitching two files on it yields a garbage window.
                # The exporter added "ts_unix" (wall-clock through the
                # process anchor) exactly for this; prefer it. Within
                # one file the rewrite is a uniform shift (harmless).
                if "ts_unix" in rec:
                    rec["ts"] = rec["ts_unix"]
                elif rec.get("kind") is None:
                    missing_anchor.add(path)
                spans.append(rec)
    if missing_anchor and len(paths) > 1:
        print("critpath: WARNING: "
              + ", ".join(sorted(os.path.basename(p)
                                 for p in missing_anchor))
              + " lack the ts_unix anchor — multi-file timelines from "
                "different processes will not align", file=sys.stderr)
    return spans


def render(block) -> str:
    lines = [f"critpath: root={block['root'] or '(none)'} "
             f"wall={block['wall_s']:.3f}s over {block['spans']} spans",
             f"  {'bucket':<16} {'critical':>10} {'share':>7} "
             f"{'busy':>10} {'overlap':>8}"]
    for b, rec in block["buckets"].items():
        if not rec["busy_s"] and not rec["critical_s"]:
            continue
        lines.append(f"  {b:<16} {rec['critical_s']:>9.3f}s "
                     f"{rec['share'] * 100:>6.1f}% "
                     f"{rec['busy_s']:>9.3f}s {rec['overlap']:>8.2f}")
    lines.append(f"  {'idle':<16} {block['idle_s']:>9.3f}s "
                 f"{block['idle_s'] / block['wall_s'] * 100 if block['wall_s'] else 0:>6.1f}%")
    lines.append("  reference trio (critical seconds): "
                 + ", ".join(f"{k}={v:.3f}s"
                             for k, v in block["trio"].items()))
    lines.append("  critical path: "
                 + " -> ".join(f"{s['name']}({s['dur_s']:.3f}s)"
                               for s in block["critical_path"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+",
                    help="span JSONL files (metrics.export_spans_jsonl)")
    ap.add_argument("--root", default="reduce_task",
                    help="root span name framing the window "
                         "(default %(default)s; absent = whole file)")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw time_accounting block")
    args = ap.parse_args(argv)
    try:
        spans = load(args.files)
    except OSError as e:
        print(f"critpath: {e}", file=sys.stderr)
        return 2
    block = analyze(spans, root_name=args.root)
    if block is None:
        print(f"critpath: no analyzable spans in {len(args.files)} "
              f"file(s) (exported with UDA_TPU_STATS=1?)",
              file=sys.stderr)
        return 3
    print(json.dumps(block) if args.json else render(block))
    return 0


if __name__ == "__main__":
    sys.exit(main())
