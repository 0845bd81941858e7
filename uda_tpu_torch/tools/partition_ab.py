"""The K1/K4 partition kernel beside the other forms of its search, on the
card, at the main path's shapes: an A/B in turns of device times.

The forms are in ``partition_ab.cu`` beside this file (PR 2's one-thread
binary search, a warp a boundary with 32 evenly spaced candidates, the same
on a power-of-two grid, four lanes a boundary on the grid, one thread a
boundary on the grid comparing word by word); the port's own kernel is
``csrc/lanes_sort.cu`` ``merge_partition_kernel``, called through
``ops/pallas_sort.merge_partition``. The input is ``chip_smoke.py`` phase
6's: 10^8 TeraSort keys (``models/terasort.teragen``) padded with
all-0xFFFFFFFF records to m = 2^27 in the keys8 layout (``uint32[8, m]``,
3 key words, the tie-break row 7), taken through the K2/K1 cascade pass
by pass; at each pass every form runs at K1's block width, is held to the
port's kernel (equal splits), and is timed queued behind a sleeping
kernel (so the host's launch cost is hidden), in order and then in
reverse. ``--k4`` repeats it on the slim ``uint32[4, m]`` layout at K4's
width. Also printed: ``nvcc -Xptxas -v`` for the forms and for
``csrc/lanes_sort.cu`` (registers, spills), and the card's name and power
limit::

    python -m uda_tpu_torch.tools.partition_ab [--forms 0,1,2,3,4]
        [--k4] [--reps 20] [--out FILE]

Needs one CUDA card and ``nvcc``; builds into ``uda_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from uda_tpu_torch.device import generator
from uda_tpu_torch.models import terasort
from uda_tpu_torch.ops import _build, pallas_fold, pallas_sort
from uda_tpu_torch.ops.sort import fill_words, i32, u32

HERE = Path(__file__).resolve().parent
FORMS = {0: "binary (PR 2)", 1: "warp, 32 evenly spaced",
         2: "warp, 32 on the grid", 3: "4 lanes on the grid",
         4: "thread on the grid, word by word"}
PORT = "port"          # the port's kernel, through its wrapper
RECORDS = 100_000_000  # chip_smoke.py's N_MAIN (BASELINE.md config 2)
TILE = 1024            # single_chip_sort's default tile
SLEEP_CYCLES = 100_000_000


def _nvcc(args: list) -> str:
    out = subprocess.run([_build.nvcc(), "-gencode",
                          "arch=compute_90a,code=sm_90a", "-std=c++17",
                          "-O3", "-Xptxas", "-v", *args],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stderr}")
    return out.stderr


def build() -> tuple:
    """The forms' library, and ptxas' report for it and for the port's
    lanes_sort.cu (compiled to an object only for the report)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "partition_ab.so"
    t0 = time.perf_counter()
    report = _nvcc(["-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(HERE / "partition_ab.cu")])
    report += _nvcc(["-c", "-o", str(_build.BUILD_DIR / "lanes_sort_ab.o"),
                     str(_build.CSRC / "lanes_sort.cu")])
    secs = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    lib.partition_ab.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_size_t, ctypes.c_void_p]
    lib.partition_ab.restype = ctypes.c_int
    return lib, report, secs


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``, queued behind a sleep."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_keys(dev: torch.device) -> torch.Tensor:
    """chip_smoke.py phase 6's key rows: 10^8 TeraSort keys, padded with
    all-0xFFFFFFFF records to m = 2^27 (``uint32[3, m]``)."""
    words = terasort.teragen(generator(0, dev), RECORDS)
    m, _ = pallas_sort.pad_pow2(RECORDS, TILE)
    keys = fill_words((terasort.KEY_WORDS, m), dev, 0xFFFFFFFF)
    i32(keys)[:, :RECORDS] = i32(words)[:, :terasort.KEY_WORDS].T
    return keys


def run_cascade(lib, mat: torch.Tensor, folded: bool, forms: list,
                reps: int) -> dict:
    rows, m = mat.shape
    nk, tb = terasort.KEY_WORDS, rows - 1
    if folded:
        y = pallas_fold.tile_sort_folded(mat, TILE, nk)
    else:
        y = pallas_sort.tile_sort(mat, TILE, nk, tb)
    names = [PORT] + forms
    passes = []
    run = TILE
    while run < m:
        width = (pallas_fold.merge_pass_folded_width(nk, m, run) if folded
                 else pallas_sort.merge_pass_width(rows, nk, m, run))
        want = pallas_sort.merge_partition(y, run, width, nk, tb)
        plain = pallas_sort.merge_partition_plain(y, run, width, nk, tb)
        if not torch.equal(want, plain):
            raise AssertionError(f"the port's kernel differs from its plain "
                                 f"version at run_len={run}")
        outs = {f: torch.empty_like(want) for f in forms}
        stream = torch.cuda.current_stream().cuda_stream

        def call(name, run=run, width=width):
            if name == PORT:
                return pallas_sort.merge_partition(y, run, width, nk, tb)
            err = lib.partition_ab(name, y.data_ptr(), outs[name].data_ptr(),
                                   m, nk, tb, width, run, stream)
            if err:
                raise RuntimeError(f"form {name}: CUDA error {err}")
            return outs[name]

        for name in forms:
            got = call(name)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"form {name} ({FORMS[name]}) differs "
                                     f"at run_len={run}")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(device_ms(lambda: call(name), reps))
        row = {"run_len": run, "width": width,
               "ms": {str(k): sum(v) / len(v) for k, v in times.items()}}
        passes.append(row)
        print(f"[partition_ab] {'K4' if folded else 'K1'} run_len=2^"
              f"{run.bit_length() - 1} width={width} "
              + " ".join(f"{k}={v:.4f}" for k, v in row["ms"].items()),
              flush=True)
        y = (pallas_fold.merge_pass_folded(y, run, TILE, nk) if folded
             else pallas_sort.merge_pass(y, run, TILE, nk, tb))
        run *= 2
    summed = {str(k): sum(p["ms"][str(k)] for p in passes) for k in names}
    print(f"[partition_ab] {'K4' if folded else 'K1'} summed over "
          f"{len(passes)} passes (device ms): "
          + " ".join(f"{k}={v:.4f}" for k, v in summed.items()), flush=True)
    return {"passes": passes, "summed_ms": summed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", default="0,1,2,3,4")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("partition_ab: no CUDA device")
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[partition_ab] {card}", flush=True)
    lib, report, secs = build()
    print(f"[partition_ab] nvcc -Xptxas -v ({secs:.1f} s):\n{report}",
          flush=True)
    forms = [int(f) for f in args.forms.split(",") if f]
    keys = main_path_keys(dev)
    res = {"card": card, "forms": {str(k): FORMS[k] for k in forms},
           "K1": run_cascade(lib, u32(torch.cat(
               [i32(keys), i32(keys).new_zeros((5, keys.shape[1]))])),
               False, forms, args.reps)}
    if args.k4:
        res["K4"] = run_cascade(lib, u32(torch.cat(
            [i32(keys), i32(keys).new_zeros((1, keys.shape[1]))])), True,
            forms, args.reps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
