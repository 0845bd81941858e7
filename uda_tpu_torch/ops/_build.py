"""Build, load and launch the port's CUDA kernels.

Every source ``uda_tpu_torch/csrc/*.cu`` becomes one shared library with a
plain C interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``. The sources include no PyTorch header, so a build takes
seconds. The build happens at first use (never at import: the package
imports on machines with no ``nvcc``), with one ``nvcc`` process per source,
all started together, into ``uda_tpu_torch/_build/``. A library's file name
carries a hash of its source, the headers and the flags, so an edited
source is rebuilt and an unchanged one reused.

Kernel wrappers count their launches in :data:`launches`, one per launch of
their kernel and nowhere else, so a run can show which kernels a path
went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["launches", "count", "reset_launches", "build_all", "library",
           "launch", "cuda_words", "smem_limit", "check_smem", "stream_of"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launches()
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _count_lock:
        launches.clear()


def count(name: str) -> None:
    """Add one launch of kernel ``name``. Under a lock: host threads (the
    hybrid merge's LPQs) launch K1 at once, and ``+= 1`` on a Counter is
    not atomic."""
    with _count_lock:
        launches[name] += 1


def nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    the toolkit's default install prefix."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError("uda_tpu_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all ``nvcc``
    processes at once, and wait for them. Returns the seconds taken.
    Raises if ``nvcc`` is missing or any build fails."""
    start = time.perf_counter()
    todo = [(src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, lib) for src, lib in todo if not lib.exists()]
    if not todo:
        return time.perf_counter() - start
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    failures = []
    try:
        for src, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([exe, *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append((src, lib, tmp, proc))
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)  # atomic: concurrent builds agree
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("uda_tpu_torch: nvcc failed:\n"
                           + "\n".join(failures))
    return time.perf_counter() - start


def library(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built first if needed),
    with ``argtypes``/``restype`` set from ``signatures``
    (name -> (argtypes, restype)): ``c_void_p`` for every pointer and the
    stream, so no pointer is cut to 32 bits."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(CSRC / f"{stem}.cu")))
            lib.uda_cuda_error_string.argtypes = [ctypes.c_int]
            lib.uda_cuda_error_string.restype = ctypes.c_char_p
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[stem] = lib
        return lib


def launch(lib: ctypes.CDLL, name: str, *args) -> None:
    """Call launcher ``name`` (which returns ``cudaGetLastError()`` after
    its launch) and raise if the launch was refused or failed."""
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.uda_cuda_error_string(err).decode()
        raise RuntimeError(f"uda_tpu_torch: {name} failed: CUDA error "
                           f"{err} ({msg})")


def cuda_words(x: torch.Tensor, rows: "int | None" = None) -> torch.Tensor:
    """Check that ``x`` is what a kernel takes: a contiguous 2-D
    ``torch.uint32`` tensor on a CUDA device (with ``rows`` rows)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must be on a CUDA device, got "
                         f"{x.device}")
    if x.dtype != torch.uint32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"kernel input must be a contiguous 2-D uint32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if rows is not None and x.shape[0] != rows:
        raise ValueError(f"kernel input must have {rows} rows, got "
                         f"{x.shape[0]}")
    if x.shape[1] > 1 << 32:
        raise ValueError("kernel input holds more than 2^32 records")
    return x


def smem_limit(device: torch.device) -> int:
    """Bytes of dynamic shared memory one block may have on ``device`` (a
    margin is kept for the kernels' static shared variables)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448)) - 64


def check_smem(need: int, device: torch.device, what: str) -> None:
    """Raise unless one block of ``what`` may have ``need`` bytes of
    dynamic shared memory on ``device``."""
    limit = smem_limit(device)
    if need > limit:
        raise ValueError(f"{what} needs {need} bytes of shared memory per "
                         f"block, over the card's {limit}: use a smaller "
                         f"tile or fewer key words")


def stream_of(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as a raw handle."""
    return torch.cuda.current_stream(x.device).cuda_stream
