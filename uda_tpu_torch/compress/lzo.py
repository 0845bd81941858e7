"""LZO1X block codec for the compressed fetch path.

The port's copy of ``uda_tpu/compress/lzo.py``. Its ladder is the
reference's: liblzo2, then the in-tree C++ codec (``csrc/lzo.cc``, the
``builtin`` rung, taken while ``uda.tpu.use.native`` is on), then pure
Python. Without liblzo2 both packages compress through their builtin
codec and write the same bytes. The pure-Python compressor emits literal
runs only, so a stream written with the switch off differs; every rung
decodes every stream.

Equivalent of the reference's LzoDecompressor (reference
src/Merger/LzoDecompressor.cc:83-127): ``liblzo2.so`` is dlopen'd at
runtime, initialised through ``__lzo_init_v2`` and driven through
``lzo1x_decompress_safe`` / ``lzo1x_1_compress``; absence of the
library is a runtime condition, not a build dependency.

Because liblzo2 is often NOT installed (it is optional in Hadoop
deployments too), this module also carries a pure-Python LZO1X
implementation of the same stream format:

- ``lzo1x_decompress_py`` decodes the full LZO1X token grammar
  (literal runs, M1-M4 matches, the 0x11 00 00 end marker), so streams
  produced by real liblzo2 decode without the native library;
- ``lzo1x_compress_py`` emits valid LZO1X streams using literal runs
  only (one initial/extended run + end marker) — decodable by any
  conforming decoder including liblzo2 itself. Compression ratio is
  ~1.0 (this is a compatibility encoder, not an optimizer); the
  native rungs compress with real lzo1x_1 matching.

The codec registers under Hadoop's LZO codec class names (the
createInputClient dispatch of reference src/Merger/reducer.cc:412-450).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

from uda_tpu_torch.utils.errors import CompressionError

__all__ = ["lzo_codec", "lzo1x_compress_py", "lzo1x_decompress_py",
           "native_lzo_available", "native_lzo_source"]

_EOS = b"\x11\x00\x00"  # M4 token with distance 0: the end-of-stream marker


# --------------------------------------------------------------------------
# pure-Python LZO1X
# --------------------------------------------------------------------------

def lzo1x_compress_py(data: bytes) -> bytes:
    """Encode ``data`` as a literal-only LZO1X stream (format-conformant,
    ratio ~1.0; see module docstring)."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    if n == 0:
        return bytes(_EOS)
    if n <= 238:
        # first-byte form: byte > 17 means an initial literal run of
        # (byte - 17) bytes (for < 4 the decoder takes the match_next
        # path, which is equally valid)
        out.append(17 + n)
        out += data
    else:
        # in-loop literal run with extended length: token 0, then
        # zero-bytes each worth 255, then a final nonzero byte; run
        # length = 15 + 255*zeros + final + 3
        t = n - 3
        x = t - 15
        zeros, final = divmod(x, 255)
        if final == 0:
            zeros -= 1
            final = 255
        out.append(0)
        out += b"\x00" * zeros
        out.append(final)
        out += data
    out += _EOS
    return bytes(out)


def lzo1x_decompress_py(src: bytes, expected_len: int) -> bytes:
    """Decode a full LZO1X stream (safe: all reads bounds-checked)."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    ip = 0

    def byte() -> int:
        nonlocal ip
        if ip >= n:
            raise CompressionError("truncated LZO stream")
        b = src[ip]
        ip += 1
        return b

    def copy_literals(count: int) -> None:
        nonlocal ip
        if ip + count > n:
            raise CompressionError("truncated LZO literal run")
        if len(out) + count > expected_len:
            # the "safe" output bound (reference lzo1x_decompress_safe's
            # NEED_OP): fail fast instead of decoding past the block's
            # declared size on corrupt input
            raise CompressionError("LZO output exceeds declared length")
        out.extend(src[ip:ip + count])
        ip += count

    def copy_match(m_pos: int, count: int) -> None:
        if m_pos < 0:
            raise CompressionError("LZO lookbehind underrun")
        if len(out) + count > expected_len:
            raise CompressionError("LZO output exceeds declared length")
        for _ in range(count):  # byte-wise: overlapping matches replicate
            out.append(out[m_pos])
            m_pos += 1

    def extended(t: int, base: int) -> int:
        nonlocal ip
        while True:
            b = byte()
            if b == 0:
                t += 255
                if t > (1 << 30):
                    raise CompressionError("LZO run length overflow")
            else:
                return t + base + b

    # ---- initial byte ----
    mode = "loop"       # next action: read a literal-run token
    t = 0
    if n and src[0] > 17:
        ip = 1
        t = src[0] - 17
        if t < 4:
            copy_literals(t)
            t = byte()
            mode = "match"      # token after short run is a match token
        else:
            copy_literals(t)
            t = byte()
            mode = "first"      # first_literal_run semantics

    while True:
        if mode == "loop":
            t = byte()
            if t < 16:
                if t == 0:
                    t = extended(0, 15)
                copy_literals(t + 3)
                t = byte()
                mode = "first"
                continue
            mode = "match"
            continue

        if mode == "first":
            # token right after a literal run: t < 16 is the special
            # 3-byte M1 match with the M2-offset bias
            if t < 16:
                m_pos = len(out) - (1 + 0x800) - (t >> 2) - (byte() << 2)
                copy_match(m_pos, 3)
                state = src[ip - 2] & 3
                mode = "done"
                continue
            mode = "match"
            continue

        if mode == "match":
            if t >= 64:          # M2: 3..8 byte match, 1-byte distance
                m_pos = len(out) - 1 - ((t >> 2) & 7) - (byte() << 3)
                count = (t >> 5) - 1 + 2
                copy_match(m_pos, count)
                state = src[ip - 2] & 3
            elif t >= 32:        # M3: distance <= 0x4000, 2-byte LE field
                t &= 31
                if t == 0:
                    t = extended(0, 31)
                d0, d1 = byte(), byte()
                m_pos = len(out) - 1 - ((d0 >> 2) + (d1 << 6))
                copy_match(m_pos, t + 2)
                state = d0 & 3
            elif t >= 16:        # M4: distance 0x4000..0xBFFF, or EOS
                m_base = len(out) - ((t & 8) << 11)
                t &= 7
                if t == 0:
                    t = extended(0, 7)
                d0, d1 = byte(), byte()
                m_pos = m_base - ((d0 >> 2) + (d1 << 6))
                if m_pos == len(out):
                    if t != 1:
                        raise CompressionError("malformed LZO end marker")
                    break        # end of stream
                copy_match(m_pos - 0x4000, t + 2)
                state = d0 & 3
            else:                # M1 inside the match loop: 2-byte match
                m_pos = len(out) - 1 - (t >> 2) - (byte() << 2)
                copy_match(m_pos, 2)
                state = src[ip - 2] & 3
            mode = "done"
            continue

        # mode == "done": state = trailing literal count from the match
        # token's low 2 bits
        if state == 0:
            mode = "loop"
        else:
            copy_literals(state)
            t = byte()
            mode = "match"

    if ip != n:
        raise CompressionError(
            f"{n - ip} trailing bytes after LZO end marker")
    if len(out) != expected_len:
        raise CompressionError(
            f"LZO length mismatch: {len(out)} != {expected_len}")
    return bytes(out)


# --------------------------------------------------------------------------
# native liblzo2 via dlopen (the reference's loading strategy)
# --------------------------------------------------------------------------

_lzo_lock = threading.Lock()
_lzo_lib = None
_lzo_missing = False  # negative probe cached: find_library spawns
                      # ldconfig — never re-probe per shuffle block
_LZO1X_1_MEM_COMPRESS = 16384 * 8  # lzo_uint is 64-bit on lp64


def _load_lzo2():
    """dlopen/dlsym liblzo2 and run __lzo_init_v2, like the reference
    (LzoDecompressor.cc:83-127); raises CompressionError if absent."""
    global _lzo_lib, _lzo_missing
    with _lzo_lock:
        if _lzo_lib is not None:
            return _lzo_lib
        if _lzo_missing:
            raise CompressionError("liblzo2.so not found")
        path = ctypes.util.find_library("lzo2")
        if not path:
            _lzo_missing = True
            raise CompressionError("liblzo2.so not found")
        lib = ctypes.CDLL(path)
        init = lib.__lzo_init_v2
        init.restype = ctypes.c_int
        # (version, sizeof(short), sizeof(int), sizeof(long),
        #  sizeof(lzo_uint32), sizeof(lzo_uint), sizeof(dict), sizeof(char*),
        #  sizeof(lzo_voidp), sizeof(lzo_callback_t)); -1 skips a check
        rc = init(1, 2, 4, 8, 4, 8, -1, 8, 8, -1)
        if rc != 0:
            raise CompressionError(f"__lzo_init_v2 failed: {rc}")
        for name in ("lzo1x_decompress_safe", "lzo1x_1_compress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
        _lzo_lib = lib
        return lib


def _load_builtin():
    """The port's in-tree C++ LZO1X codec (``uda_tpu_torch/csrc/lzo.cc``,
    the reference's ``uda_tpu/native/lzo.cc``): same stream format,
    uda_-prefixed symbols. Refused with ``CompressionError`` while
    ``uda.tpu.use.native`` is off; with it on, a library that cannot be
    built raises its ``RuntimeError`` (the port does not degrade)."""
    from uda_tpu_torch import native as native_mod
    from uda_tpu_torch.utils.ifile import native_enabled

    if not native_enabled():
        raise CompressionError("builtin native LZO unavailable "
                               "(uda.tpu.use.native is off)")
    native_mod.build()
    return native_mod


def native_lzo_source() -> str:
    """Which native LZO implementation serves: "liblzo2" (the
    reference's dlopen target), "builtin" (``csrc/lzo.cc``), or ""
    (pure Python only)."""
    try:
        _load_lzo2()
        return "liblzo2"
    except CompressionError:
        pass
    try:
        _load_builtin()
        return "builtin"
    except CompressionError:
        return ""


def native_lzo_available() -> bool:
    return bool(native_lzo_source())


def _native_compress(data: bytes) -> bytes:
    try:
        lib = _load_lzo2()
    except CompressionError:
        return _builtin_compress(data)
    out = ctypes.create_string_buffer(len(data) + len(data) // 16 + 67)
    out_len = ctypes.c_size_t(len(out))
    wrk = ctypes.create_string_buffer(_LZO1X_1_MEM_COMPRESS)
    rc = lib.lzo1x_1_compress(data, len(data), out, ctypes.byref(out_len),
                              wrk)
    if rc != 0:
        raise CompressionError(f"lzo1x_1_compress failed: {rc}")
    return out.raw[: out_len.value]


def _native_decompress(data: bytes, uncompressed_len: int) -> bytes:
    try:
        lib = _load_lzo2()
    except CompressionError:
        return _builtin_decompress(data, uncompressed_len)
    out = ctypes.create_string_buffer(max(uncompressed_len, 1))
    out_len = ctypes.c_size_t(uncompressed_len)
    rc = lib.lzo1x_decompress_safe(data, len(data), out,
                                   ctypes.byref(out_len), None)
    if rc != 0:
        raise CompressionError(f"lzo1x_decompress_safe failed: {rc}")
    if out_len.value != uncompressed_len:
        raise CompressionError(
            f"lzo length mismatch: {out_len.value} != {uncompressed_len}")
    return out.raw[: out_len.value]


def _builtin_compress(data: bytes) -> bytes:
    rc, out = _load_builtin().lzo1x_1_compress(data)
    if rc != 0:
        raise CompressionError(f"builtin lzo compress failed: {rc}")
    return out


def _builtin_decompress(data: bytes, uncompressed_len: int) -> bytes:
    rc, out = _load_builtin().lzo1x_decompress_safe(data, uncompressed_len)
    if rc != 0:
        raise CompressionError(f"builtin lzo decompress failed: {rc}")
    if len(out) != uncompressed_len:
        raise CompressionError(
            f"lzo length mismatch: {len(out)} != {uncompressed_len}")
    return out


def lzo_codec():
    """Codec factory: native liblzo2 when loadable, else the in-tree C++
    codec, else the pure-Python LZO1X implementation (the same stream
    format in all three). The pair is bound once here: per-block calls
    never re-probe for liblzo2."""
    from uda_tpu_torch.compress import Codec

    source = native_lzo_source()
    if source == "liblzo2":
        return Codec("lzo", _native_compress, _native_decompress)
    if source == "builtin":
        return Codec("lzo", _builtin_compress, _builtin_decompress)
    return Codec("lzo",
                 lzo1x_compress_py,
                 lambda data, length: lzo1x_decompress_py(data, length))
