#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``uda_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
``sm_90a``)::

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``uda_tpu_torch/csrc`` compiled with ``nvcc``;
3. kernels: K2/K1 through ``sort_lanes`` at 8 and 32 rows (``two_phase``
   off and on) and K3/K4 through ``sort_lanes_folded4``, at 2^20 records
   with tiles 1024 and 4096, on keys with duplicates, words >= 2^31 and
   all-0xFFFFFFFF keys; every launch held byte for byte against its plain
   PyTorch version on the same input, and the result against PyTorch's
   stable sort;
4. main path: ``single_chip_sort`` of 100,000,000 TeraSort records
   (BASELINE.md config 2, 10.4 GB of ``uint32[n, 26]``, padded to 2^27
   inside) with ``path="auto"``, which resolves to ``keys8`` (K2 + K1), then
   the same records through ``keys8f`` (K3 + K4); each checked for order,
   multiset checksum and byte identity with the stable-sort yardstick,
   with the launches of every kernel counted;
5. engines: all eight engines on 2^22 records give the same bytes, and
   ``bench_step`` runs 2 rounds of ``keys8``;
6. times, with CUDA events at the main path's shapes: each kernel (K1 and
   K4 per pass and summed over the cascade), its plain version, PyTorch's
   stable sort computing the same function, its bound, the cascades and
   the whole-sort yardstick;
7. profile: device time by kernel and the device's idle share over one
   main-path call (``torch.profiler``).

The last two lines are one JSON object with a record per kernel and the
contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from uda_tpu_torch.device import generator
from uda_tpu_torch.models import terasort
from uda_tpu_torch.ops import _build, pallas_fold, pallas_sort
from uda_tpu_torch.ops import sort as sort_ops
from uda_tpu_torch.ops.sort import _as_i64, fill_words, i32, u32, words_of

SEED = 0
N_MAIN = 100_000_000       # BASELINE.md config 2: TeraSort 10 GB
N_ENGINES = 1 << 22
N_KERNEL = 1 << 20
KERNEL_TILES = (1024, 4096)
MAIN_TILE = 1024           # single_chip_sort's default tile
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
OPS_PER_S = 67e12          # H100 SXM 32-bit rate outside the tensor cores
TIMED_REPS = 5

KERNELS = {
    "merge_pass": dict(
        id="K1", route="cuda", source="uda_tpu_torch/csrc/lanes_sort.cu",
        replaces="uda_tpu/ops/pallas_sort.py:310"),
    "tile_sort": dict(
        id="K2", route="cuda", source="uda_tpu_torch/csrc/lanes_sort.cu",
        replaces="uda_tpu/ops/pallas_sort.py:133"),
    "tile_sort_folded": dict(
        id="K3", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:90"),
    "merge_pass_folded": dict(
        id="K4", route="cuda", source="uda_tpu_torch/csrc/lanes_fold.cu",
        replaces="uda_tpu/ops/pallas_fold.py:135"),
}
_ALL_ONES = 0xFFFFFFFF


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words (0: byte-identical)."""
    return int((_as_i64(a) - _as_i64(b)).abs().max())


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(i32(a), i32(b))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = TIMED_REPS, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the 32-bit vector rate.
    Returns (ms, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---------------------------------------------------------------- phase 1
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; count {torch.cuda.device_count()}")
    return {"smi": smi, "kind": kind, "count": torch.cuda.device_count()}


# ---------------------------------------------------------------- phase 2
def phase_build() -> float:
    secs = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(list(_build.CSRC.glob('*.cu')))} "
        f"sources: {secs:.1f} s")
    return secs


# ---------------------------------------------------------------- phase 3
def test_words(gen: torch.Generator, rows: int, n: int,
               num_keys: int) -> torch.Tensor:
    """Random uint32[rows, n] whose key rows mix random words with a small
    alphabet (duplicates, words >= 2^31, all-0xFFFFFFFF keys)."""
    dev = gen.device
    x = torch.randint(-(1 << 31), 1 << 31, (rows, n), dtype=torch.int32,
                      generator=gen, device=dev).view(torch.uint32)
    alphabet = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, _ALL_ONES],
                            dtype=torch.int64, device=dev)
    pick = torch.randint(0, len(alphabet), (num_keys, n), generator=gen,
                         device=dev)
    small = torch.rand((1, n), generator=gen, device=dev) < 0.5
    keys = torch.where(small, alphabet[pick], _as_i64(x[:num_keys]))
    i32(x)[:num_keys] = i32(words_of(keys))
    return x


def stable_reference(x: torch.Tensor, num_keys: int,
                     tb_row: int) -> torch.Tensor:
    """The sorted lanes array by PyTorch's stable sort."""
    perm = sort_ops.stable_lex_argsort(list(x[:num_keys]))
    out = sort_ops.take_cols(x, perm)
    i32(out)[tb_row] = i32(words_of(perm))
    return out


def cascade(folded: bool, num_keys: int, tb_row: int) -> tuple:
    """One cascade's kernel wrappers and plain versions, the launch-counter
    names and the arguments after (x, [run_len,] tile): (tile sort, its
    plain version, merge pass, its plain version, names, args)."""
    if folded:
        return (pallas_fold.tile_sort_folded,
                pallas_fold.tile_sort_folded_plain,
                pallas_fold.merge_pass_folded,
                pallas_fold.merge_pass_folded_plain,
                ("tile_sort_folded", "merge_pass_folded"), (num_keys,))
    return (pallas_sort.tile_sort, pallas_sort.tile_sort_plain,
            pallas_sort.merge_pass, pallas_sort.merge_pass_plain,
            ("tile_sort", "merge_pass"), (num_keys, tb_row))


def check_cascade(x: torch.Tensor, num_keys: int, tb_row: int, tile: int,
                  folded: bool) -> dict:
    """Run the cascade kernel by kernel, holding each launch against its
    plain version on the same input; returns the largest error of each."""
    first, first_plain, step, step_plain, names, args = cascade(
        folded, num_keys, tb_row)
    errs = dict.fromkeys(names, 0)
    y = first(x, tile, *args)
    errs[names[0]] = max_abs_err(y, first_plain(x, tile, *args))
    for lvl in range((x.shape[1] // tile).bit_length() - 1):
        z = step(y, tile << lvl, tile, *args)
        errs[names[1]] = max(errs[names[1]],
                             max_abs_err(z, step_plain(y, tile << lvl, tile,
                                                       *args)))
        y = z
    require(same(y, stable_reference(x, num_keys, tb_row)),
            f"{names} cascade differs from the stable sort")
    torch.cuda.synchronize()
    return errs


def phase_kernels(dev: torch.device, n: int = N_KERNEL,
                  tiles=KERNEL_TILES) -> dict:
    gen = generator(SEED + 1, dev)
    worst: dict = {}
    for tile in tiles:
        cases = [(8, 3, 7, False), (32, 3, 31, False), (4, 3, 3, True)]
        for rows, nk, tb, folded in cases:
            x = test_words(gen, rows, n, nk)
            errs = check_cascade(x, nk, tb, tile, folded)
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0), err)
            if folded:
                public = pallas_fold.sort_lanes_folded4(x, nk, tile=tile)
                require(same(public, stable_reference(x, nk, tb)),
                        "sort_lanes_folded4 differs from the stable sort")
            else:
                ref = stable_reference(x, nk, tb)
                for two_phase in (False, True):
                    got = pallas_sort.sort_lanes(x, nk, tb, tile=tile,
                                                 two_phase=two_phase)
                    require(same(got, ref),
                            f"sort_lanes rows={rows} two_phase={two_phase}"
                            f" differs from the stable sort")
            torch.cuda.synchronize()
            log(f"[kernels] rows={rows} keys={nk} tile={tile} n={n}: "
                f"max_abs_err against the plain versions {errs} "
                f"(tolerance 0); public cascade equal to the stable sort")
    require(all(v == 0 for v in worst.values()),
            f"kernel differs from its plain version: {worst}")
    return worst


# ---------------------------------------------------------------- phase 4
def run_path(words: torch.Tensor, path: str, kernels: tuple,
             reference: torch.Tensor) -> dict:
    """One drive of single_chip_sort with the launch counts reset just
    before and read just after; checks order, checksum and bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = terasort.single_chip_sort(words, path=path, device=words.device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: _build.launches[k] for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    require(all(counts.values()), f"{path}: a kernel never launched "
                                  f"{counts}")
    require(out.shape == words.shape and out.dtype == torch.uint32,
            f"{path}: output {out.dtype} {tuple(out.shape)}")
    terasort.validate_sorted(out, words)
    require(same(out, reference),
            f"{path}: output differs from the stable-sort yardstick")
    log(f"[main] {path}: n={words.shape[0]} {secs:.3f} s (first call, host "
        f"clock), launches {counts}, peak {peak / 2**30:.2f} GiB; sorted, "
        f"checksum equal, equal to the yardstick")
    return {"path": path, "seconds": secs, "launches": counts,
            "peak_bytes": peak}


def yardstick(words: torch.Tensor) -> torch.Tensor:
    """The whole sort by PyTorch's stable sort: never on the port's path."""
    perm = sort_ops.stable_lex_argsort(list(words.T[:terasort.KEY_WORDS]))
    return u32(i32(words)[perm])


def phase_main(dev: torch.device, n: int = N_MAIN) -> tuple:
    words = terasort.teragen(generator(SEED, dev), n)
    auto = sort_ops.route_engine(n, "auto", lanes_ok=True, device=dev)
    require(auto == "keys8", f'"auto" resolved to {auto!r}, not keys8')
    reference = yardstick(words)
    runs = [run_path(words, "auto", ("tile_sort", "merge_pass"), reference),
            run_path(words, "keys8f",
                     ("tile_sort_folded", "merge_pass_folded"), reference)]
    return words, runs


# ---------------------------------------------------------------- phase 5
def phase_engines(dev: torch.device, n: int = N_ENGINES) -> dict:
    words = terasort.teragen(generator(SEED + 2, dev), n)
    reference = yardstick(words)
    _build.reset_launches()
    for path in sort_ops.ALL_SORT_PATHS:
        out = terasort.single_chip_sort(words, path=path, device=dev)
        require(same(out, reference), f"engine {path} differs")
    counts = dict(_build.launches)
    viol, ck_in, ck_out = terasort.bench_step(SEED, n, 2, "keys8",
                                               device=dev)
    require(int(viol) == 0 and int(ck_in) == int(ck_out),
            f"bench_step keys8: {int(viol)} violations, checksums "
            f"{int(ck_in)} / {int(ck_out)}")
    torch.cuda.synchronize()
    log(f"[engines] {len(sort_ops.ALL_SORT_PATHS)} engines at n={n}: "
        f"identical; launches {counts}; bench_step keys8 k=2: 0 "
        f"violations, checksums equal")
    return counts


# ---------------------------------------------------------------- phase 6
def library_sort(x: torch.Tensor, seg: int, num_keys: int,
                 tb_row: "int | None") -> torch.Tensor:
    """What a kernel computes, by PyTorch's stable sort (``torch.sort``
    over int64-packed key words; no single PyTorch call sorts by an 80-bit
    key): every segment of ``seg`` columns sorted by its key rows, then
    every row moved by the permutation. With ``tb_row`` it is K2/K3 (the
    tie-break row set to the arrival index); without, one K1/K4 pass,
    whose run pairs are the segments and whose tie-break row orders
    equal keys. Never on the port's path: the ``library_ms`` yardstick."""
    rows, m = x.shape
    key_rows = list(range(num_keys)) + ([] if tb_row is not None
                                        else [rows - 1])
    order = sort_ops.stable_lex_argsort(
        [x[r].view(-1, seg) for r in key_rows], dim=1)
    src = (order + torch.arange(0, m, seg, device=x.device)[:, None]
           ).flatten()
    out = sort_ops.take_cols(x, src)
    if tb_row is not None:
        i32(out)[tb_row] = i32(words_of(src))
    return out


def time_cascade(mat: torch.Tensor, tile: int, folded: bool,
                 reps: int) -> dict:
    """Time each kernel of one cascade at ``mat``'s shape, its plain
    version and PyTorch's stable sort on the same input, and compare
    them."""
    rows, m = mat.shape
    nk = terasort.KEY_WORDS
    tb = rows - 1
    first, first_plain, step, step_plain, names, args = cascade(folded, nk,
                                                                tb)
    word = 4
    words_compared = nk + 1   # key words and the tie-break
    y = first(mat, tile, *args)
    require(same(library_sort(mat, tile, nk, tb), y),
            f"{names[0]}: PyTorch's per-tile sort differs")
    res = {names[0]: {
        "ms": time_ms(lambda: first(mat, tile, *args), reps),
        "plain_ms": time_ms(lambda: first_plain(mat, tile, *args), 1,
                            warmup=0),
        "library_ms": time_ms(lambda: library_sort(mat, tile, nk, tb), 1),
        # reads every row but the tie-break, writes every row
        "bytes": (2 * rows - 1) * m * word,
        # a merge sort of each tile: log2(tile) compares per record
        "ops": m * (tile.bit_length() - 1) * words_compared,
        "max_abs_err": max_abs_err(y, first_plain(mat, tile, *args)),
    }}
    spare = torch.empty_like(y)
    per_pass = []
    errs = 0
    plain_total = library_total = 0.0
    for lvl in range((m // tile).bit_length() - 1):
        L = tile << lvl
        per_pass.append(time_ms(lambda: step(y, L, tile, *args, out=spare),
                                reps))
        plain_total += time_ms(lambda: step_plain(y, L, tile, *args), 1,
                               warmup=0)
        library_total += time_ms(lambda: library_sort(y, 2 * L, nk, None),
                                 1, warmup=0)
        z = step(y, L, tile, *args, out=spare)
        errs = max(errs, max_abs_err(z, step_plain(y, L, tile, *args)))
        require(same(library_sort(y, 2 * L, nk, None), z),
                f"{names[1]}: PyTorch's sort of each run pair differs")
        y, spare = z, y
    res[names[1]] = {
        "ms": sum(per_pass), "per_pass_ms": per_pass,
        "plain_ms": plain_total, "library_ms": library_total,
        "bytes": len(per_pass) * 2 * rows * m * word,
        # a merge: one compare per record and pass
        "ops": len(per_pass) * m * words_compared,
        "max_abs_err": errs,
    }
    torch.cuda.synchronize()
    return res


def phase_times(words: torch.Tensor, tile: int = MAIN_TILE,
                reps: int = TIMED_REPS) -> dict:
    n = words.shape[0]
    m, tile = pallas_sort.pad_pow2(n, tile)
    keyr = fill_words((terasort.KEY_WORDS, m), words.device, _ALL_ONES)
    i32(keyr)[:, :n] = i32(words)[:, :terasort.KEY_WORDS].T
    mat8 = u32(torch.cat([i32(keyr), i32(keyr).new_zeros((5, m))]))
    mat4 = u32(torch.cat([i32(keyr), i32(keyr).new_zeros((1, m))]))
    times = time_cascade(mat8, tile, False, reps)
    times.update(time_cascade(mat4, tile, True, reps))
    del mat8, mat4
    require(all(t["max_abs_err"] == 0 for t in times.values()),
            "a kernel differs from its plain version at the main path's "
            "shapes")
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"])
        log(f"[times] {KERNELS[name]['id']} {name} at m={m} tile={tile}: "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, torch.sort "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops), "
            f"max_abs_err {t['max_abs_err']} (tolerance 0)")
        if "per_pass_ms" in t:
            log(f"[times] {name} per pass (ms): "
                + " ".join(f"{v:.3f}" for v in t["per_pass_ms"]))
    keys = list(keyr)
    casc = {
        "keys8_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile), 3),
        "keys8f_cascade_ms": time_ms(
            lambda: pallas_sort.keys8_sort_perm(keyr, tile=tile,
                                                folded=True), 3),
        "yardstick_perm_ms": time_ms(
            lambda: sort_ops.stable_lex_argsort(keys), 3),
        "single_chip_sort_keys8_ms": time_ms(
            lambda: terasort.single_chip_sort(words, device=words.device),
            2),
        "single_chip_sort_keys8f_ms": time_ms(
            lambda: terasort.single_chip_sort(words, path="keys8f",
                                              device=words.device), 2),
        "yardstick_sort_ms": time_ms(lambda: yardstick(words), 2),
        "records": n,
        "padded_records": m,
        "tile": tile,
    }
    log("[times] cascades " + json.dumps(casc))
    return {"kernels": times, "cascades": casc}


def phase_profile(words: torch.Tensor) -> dict:
    """Where the main path's time goes: ``torch.profiler`` over one keys8
    ``single_chip_sort`` call, device time summed by kernel name, and the
    device's busy share of the call (the union of device intervals over
    the host clock around the call, profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        terasort.single_chip_sort(words, device=words.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("[profile] the profiler saw no device activity: not measured")
        return {}
    by_name: dict = {}
    busy = 0.0
    reach = spans[0][0]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    prof_out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                "idle_share": 1.0 - busy / wall_us,
                "device_ms_by_kernel": {k[:80]: v / 1e3 for k, v in top}}
    log("[profile] keys8 single_chip_sort " + json.dumps(prof_out))
    return prof_out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = phase_device()
    phase_build()
    phase_kernels(dev)
    words, runs = phase_main(dev)
    phase_engines(dev)
    timed = phase_times(words)
    phase_profile(words)
    launches = {}
    for run in runs:
        launches.update(run["launches"])
    kernels = []
    for name, meta in KERNELS.items():
        t = timed["kernels"][name]
        kernels.append({
            "name": f"{meta['id']} {name}", "route": meta["route"],
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    log(f"[main] peak memory: " + ", ".join(
        f"{r['path']} {r['peak_bytes']} B" for r in runs))
    log(info["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
