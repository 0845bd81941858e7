"""Systematic k-of-n Reed-Solomon over GF(2^8) for map-output stripes.

The port's copy of ``uda_tpu/coding/rs.py`` (host numpy, as there).

The construction is Cauchy-RS (the jerasure/Coded-TeraSort shape,
arXiv:1702.04850): the generator is ``[I_k ; C]`` where ``C`` is an
(n-k) x k Cauchy matrix ``C[j,i] = 1/(x_j + y_i)`` with disjoint
``x_j = k+j`` and ``y_i = i``. Every k x k submatrix of such a stacked
matrix is invertible (the MDS property: deleting identity rows reduces
the minor to a smaller Cauchy minor, and every Cauchy minor is
nonsingular), so ANY k of the n stripe chunks reconstruct the data.

Systematic means chunks ``0..k-1`` ARE the data (byte slices of the
partition blob) — the healthy path never decodes, and ``n == k``
degenerates to plain chunking with zero parity and byte identity by
construction.

Stripe geometry: a blob of L bytes codes as k data chunks of
``chunk_len = ceil(L/k)`` (the last one short; coding pads with zeros
virtually) plus ``n-k`` parity chunks of exactly ``chunk_len``.
Decoding trims back to L. ``L == 0`` is the empty stripe: no chunks
carry bytes and decode returns ``b""``.
"""

from __future__ import annotations

import numpy as np

from uda_tpu_torch.coding import gf256
from uda_tpu_torch.utils.errors import StorageError

__all__ = ["chunk_len", "parity_matrix", "encode_parity", "split_data",
           "decode"]

_MAX_N = 255  # x_j/y_i live in GF(2^8); n beyond that has no MDS rows


def _validate(k: int, n: int) -> None:
    if not (1 <= k <= n <= _MAX_N):
        raise StorageError(f"bad RS stripe geometry k={k}, n={n} "
                           f"(need 1 <= k <= n <= {_MAX_N})")


def chunk_len(total_len: int, k: int) -> int:
    return (total_len + k - 1) // k if total_len > 0 else 0


def parity_matrix(k: int, n: int) -> np.ndarray:
    """The (n-k, k) Cauchy parity rows."""
    _validate(k, n)
    rows = n - k
    c = np.zeros((rows, k), dtype=np.uint8)
    for j in range(rows):
        for i in range(k):
            c[j, i] = gf256.gf_inv((k + j) ^ i)
    return c


def split_data(blob: bytes, k: int) -> list[bytes]:
    """The k systematic data chunks (unpadded byte slices; the last may
    be short or empty)."""
    cl = chunk_len(len(blob), k)
    if cl == 0:
        return [b""] * k
    return [bytes(blob[i * cl:(i + 1) * cl]) for i in range(k)]


def _padded_matrix(chunks: list[bytes], cl: int) -> np.ndarray:
    m = np.zeros((len(chunks), cl), dtype=np.uint8)
    for i, ch in enumerate(chunks):
        if len(ch) > cl:
            raise StorageError(f"stripe chunk {i} longer than chunk_len "
                               f"({len(ch)} > {cl})")
        if ch:
            m[i, :len(ch)] = np.frombuffer(ch, dtype=np.uint8)
    return m


def encode_parity(blob: bytes, k: int, n: int) -> list[bytes]:
    """The n-k parity chunks of ``blob``'s stripe, each exactly
    ``chunk_len(len(blob), k)`` bytes (empty list when n == k or the
    blob is empty)."""
    _validate(k, n)
    if n == k:
        return []
    if not blob:
        return [b""] * (n - k)  # the empty stripe: uniform shape
    cl = chunk_len(len(blob), k)
    data = _padded_matrix(split_data(blob, k), cl)
    parity = gf256.matmul(parity_matrix(k, n), data)
    return [parity[j].tobytes() for j in range(n - k)]


def decode(chunks: dict[int, bytes], k: int, n: int,
           total_len: int) -> bytes:
    """Reconstruct the original blob from ANY k of the n stripe chunks.

    ``chunks`` maps chunk index (0..n-1) to its bytes — data chunks may
    be short (the stored tail is unpadded); parity chunks must be full
    ``chunk_len`` long. Extra entries beyond k are ignored (data
    preferred, then lowest index). Raises StorageError when fewer than
    k distinct chunks are supplied.
    """
    _validate(k, n)
    if total_len == 0:
        return b""
    have = sorted(chunks)
    if any(i < 0 or i >= n for i in have):
        raise StorageError(f"stripe chunk index out of range in {have} "
                           f"(n={n})")
    if len(have) < k:
        raise StorageError(f"stripe unrecoverable: {len(have)} of the "
                           f"required {k} chunks present (have {have})")
    cl = chunk_len(total_len, k)
    # prefer the systematic chunks: identity rows cost nothing to invert
    use = sorted(have, key=lambda i: (i >= k, i))[:k]
    if use == list(range(k)):  # all-data fast path: pure concatenation
        out = b"".join(chunks[i][:cl] for i in range(k))
        return out[:total_len]
    cauchy = parity_matrix(k, n)
    rows = np.zeros((k, k), dtype=np.uint8)
    for r, idx in enumerate(use):
        if idx < k:
            rows[r, idx] = 1
        else:
            rows[r] = cauchy[idx - k]
    shards = _padded_matrix([chunks[i] for i in use], cl)
    data = gf256.matmul(gf256.inv_matrix(rows), shards)
    return data.reshape(-1).tobytes()[:total_len]
