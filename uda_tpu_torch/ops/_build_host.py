"""Build the port's host C++ with the host compiler.

``build_native()`` builds the native host runtime: ``csrc/codec.cc``,
``reader.cc``, ``merge.cc`` and ``lzo.cc`` (with ``vlong.h``) become
``libuda_tpu_native.so``, with the flags of the reference's
``uda_tpu/native/Makefile``, into ``native-<hash>/`` of the build
directory. The hash covers the sources and the flags. The library is
linked into a temporary file that is then renamed, under an exclusive
``fcntl.flock`` of a lock file beside it, so processes that start at
once (xdist workers) compile once and every one loads a whole library.

``csrc/bridge_shim.cc`` becomes ``libuda_tpu_bridge.so`` (it embeds
CPython, so it compiles against ``Python.h`` and links ``libpython``) and
``csrc/bridge_shim_test.cc`` the standalone embedder ``bridge_shim_test``
that links it. Both are built with ``g++`` at first use (never at import)
into a directory of ``uda_tpu_torch/_build/`` (or of the directory
``utils/compile_cache`` names) whose name carries a hash of
the sources, the flags and the Python they embed, so an edited source is
rebuilt and an unchanged one reused. The reference's ``uda_tpu/native/``
is neither read nor written.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
import time
from pathlib import Path

__all__ = ["build_shim", "build_native", "SHIM_SOURCES", "NATIVE_SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SHIM_SOURCES = (CSRC / "bridge_shim.cc", CSRC / "bridge_shim_test.cc")
LIB_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")
NATIVE_SOURCES = tuple(CSRC / n for n in ("codec.cc", "reader.cc",
                                          "merge.cc", "lzo.cc"))
NATIVE_HEADERS = (CSRC / "vlong.h",)
NATIVE_LIB = "libuda_tpu_native.so"
EMBEDDER_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-pthread")


def _python_flags() -> tuple:
    """(include flags, link flags) of the Python the shim embeds: the
    headers from ``python3-config --includes``, the library of the running
    interpreter (its ``LIBDIR`` and ``LDVERSION``)."""
    includes = subprocess.run(["python3-config", "--includes"],
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.split()
    libdir = sysconfig.get_config_var("LIBDIR")
    lib = "python" + sysconfig.get_config_var("LDVERSION")
    return tuple(includes), (f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                             f"-l{lib}")


def _run(cmd: list) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"uda_tpu_torch: {' '.join(cmd)} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")


def build_shim() -> tuple:
    """Build the shim library and its embedder unless built already.
    Returns (path of ``bridge_shim_test``, seconds taken). Raises if a
    tool is missing or a build fails."""
    from uda_tpu_torch.utils import compile_cache

    start = time.perf_counter()
    compile_cache.enable()
    for tool in ("g++", "python3-config"):
        if shutil.which(tool) is None:
            raise RuntimeError(f"uda_tpu_torch: {tool} not found; the "
                               f"bridge shim cannot be built")
    includes, link = _python_flags()
    digest = hashlib.sha256(" ".join(
        LIB_FLAGS + EMBEDDER_FLAGS + includes + link).encode())
    for src in SHIM_SOURCES:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"bridge-{digest.hexdigest()[:16]}"
    exe = out / "bridge_shim_test"
    if exe.exists():
        return str(exe), time.perf_counter() - start
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out.name}.", dir=BUILD_DIR))
    try:
        _run(["g++", *LIB_FLAGS, *includes, "-o",
              str(tmp / "libuda_tpu_bridge.so"), str(SHIM_SOURCES[0]),
              *link])
        _run(["g++", *EMBEDDER_FLAGS, "-o", str(tmp / "bridge_shim_test"),
              str(SHIM_SOURCES[1]), f"-L{tmp}", "-Wl,-rpath,$ORIGIN",
              "-luda_tpu_bridge"])
        try:
            os.rename(tmp, out)  # atomic: a concurrent build agrees
        except OSError:
            if not exe.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return str(exe), time.perf_counter() - start


def native_path() -> Path:
    """Where ``build_native`` puts the library for the current sources."""
    digest = hashlib.sha256(" ".join(LIB_FLAGS).encode())
    for src in NATIVE_SOURCES + NATIVE_HEADERS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"native-{digest.hexdigest()[:16]}" / NATIVE_LIB


def build_native() -> tuple:
    """Build ``libuda_tpu_native.so`` unless built already. Returns (path
    of the library, seconds taken). Raises ``RuntimeError`` with the
    compiler's stderr if ``g++`` is missing or the build fails."""
    from uda_tpu_torch.utils import compile_cache

    start = time.perf_counter()
    compile_cache.enable()
    lib = native_path()
    if lib.exists():
        return str(lib), time.perf_counter() - start
    if shutil.which("g++") is None:
        raise RuntimeError("uda_tpu_torch: g++ not found; the native host "
                           "runtime cannot be built")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        lock = open(lib.parent / ".lock", "w")
    except OSError as e:
        raise RuntimeError(f"uda_tpu_torch: cannot write the native build "
                           f"directory {lib.parent}: {e}") from e
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():  # another process may have built it meanwhile
            tmp = lib.with_name(f"{NATIVE_LIB}.{os.getpid()}.tmp")
            try:
                _run(["g++", *LIB_FLAGS, "-o", str(tmp),
                      *map(str, NATIVE_SOURCES)])
                os.replace(tmp, lib)  # a dlopen never sees half a file
            finally:
                tmp.unlink(missing_ok=True)
    return str(lib), time.perf_counter() - start
