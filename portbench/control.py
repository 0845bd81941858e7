"""The control of ``correct``: a cell run with the plain reference in the
program's place, computed a step below what the configuration states
(the key's first 4 bytes alone, where the configuration orders by the
whole 10-byte key). It has to come out as not correct; the benchmark's
own runs never run it::

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

Each seed runs in this one process and prints the cell's result line,
whose ``checks`` hold the control's readings; the exit code is 0 only
where every seed came out not correct.
"""

import json
import sys

from portbench.run import pin_environment


def main(argv=None, root=None, device=None) -> int:
    import argparse
    import io
    from pathlib import Path

    from portbench import harness

    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = harness.PACKAGE_DIR.parent if root is None else Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    kind = json.loads(harness.find_file(root, "traffic",
                                        cell["traffic"] + ".json")
                      .read_text())["driver"]
    control = harness.load_module(root, "reference", kind).control
    all_failed = True
    for seed in args.seeds.split(","):
        out = io.StringIO()
        rc = harness.main(["--workload", args.workload, "--seed", seed,
                           "--seconds", str(args.seconds)],
                          root=root, device=device, system=control, out=out)
        line = json.loads(out.getvalue().splitlines()[-1]) if rc == 0 \
            else None
        print(json.dumps({"seed": int(seed), "rc": rc, "control": line}),
              flush=True)
        all_failed &= line is not None and not line["correct"]
    return 0 if all_failed else 1


if __name__ == "__main__":
    pin_environment()
    sys.exit(main())
