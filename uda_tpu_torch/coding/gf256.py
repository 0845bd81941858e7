"""Vectorized GF(2^8) arithmetic — the finite-field arithmetic under the
Reed-Solomon map-output coding (``coding/rs``). The port's copy of
``uda_tpu/coding/gf256.py``; host numpy, as in the reference.

Pure numpy, no native deps: multiplication is one 256x256 table
(``MUL``, 64 KB, built once at import from log/exp tables over the
classic RS polynomial 0x11D with generator 2 — the QR/RS-255 field),
so a scalar-by-vector product is a single fancy-index gather and a
matrix-vector product over chunk bytes is k gathers + k XORs.

Addition/subtraction in GF(2^8) are XOR; ``a/b = a * inv(b)`` with
``inv(a) = EXP[255 - LOG[a]]``. Division by zero raises — a zero pivot
in the decode matrix would mean a non-MDS construction, which the
Cauchy parity rows rule out by design (see rs.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["EXP", "LOG", "MUL", "gf_mul", "gf_inv", "mul_vec",
           "matmul", "inv_matrix"]

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, generator alpha = 2

EXP = np.zeros(510, dtype=np.uint8)
LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
EXP[255:510] = EXP[:255]  # wraparound: EXP[i+j] needs no mod 255

# Full multiplication table: MUL[a][b] = a*b in GF(2^8). MUL[a] is a
# 256-entry row, so MUL[a][vec] is the vectorized scalar-vector product.
MUL = np.zeros((256, 256), dtype=np.uint8)
_nz = np.arange(1, 256)
MUL[1:, 1:] = EXP[(LOG[_nz][:, None] + LOG[_nz][None, :]) % 255]


def gf_mul(a: int, b: int) -> int:
    return int(MUL[a, b])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(EXP[255 - LOG[a]])


def mul_vec(c: int, v: np.ndarray) -> np.ndarray:
    """Scalar-by-vector product (one table gather)."""
    if c == 0:
        return np.zeros_like(v)
    if c == 1:
        return v
    return MUL[c][v]


def matmul(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: ``a`` is (r, c) uint8, ``x`` is (c, L)
    uint8 (c chunk rows of L bytes) -> (r, L). XOR-accumulated table
    gathers; O(r*c) gathers over L-byte rows."""
    r, c = a.shape
    out = np.zeros((r, x.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(c):
            coeff = int(a[i, j])
            if coeff:
                acc ^= mul_vec(coeff, x[j])
    return out


def inv_matrix(a: np.ndarray) -> np.ndarray:
    """Invert a (k, k) GF(2^8) matrix by Gauss-Jordan elimination.
    Raises ``np.linalg.LinAlgError`` on a singular matrix (cannot
    happen for the k-subsets of the rs.py generator by the Cauchy/MDS
    property — a raise here means corrupted chunk indexing)."""
    k = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8),
                          np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        pivot = None
        for row in range(col, k):
            if aug[row, col]:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = mul_vec(inv_p, aug[col])
        for row in range(k):
            if row != col and aug[row, col]:
                aug[row] ^= mul_vec(int(aug[row, col]), aug[col])
    return aug[:, k:].copy()
