"""GF(2^8) arithmetic on device words for the coded multicast exchange.

Counterpart of ``uda_tpu/coding/gfjax.py``. The coded stage-B path
(``parallel/exchange.coded_round_body``) encodes a pod pair's
per-destination row blocks on the slots' devices. GF(2^8) acts bytewise
on the ``uint32`` record words, so a scalar-by-tensor product is a lookup
of every byte lane of the words (their uint8 view, as int64 indices) in
row ``coeff`` of the 256x256 ``MUL`` table of ``coding/gf256``, the host
codec's table; addition is XOR of whole words (int32 views: torch's
``uint32`` has no XOR on the card). Everything is exact integer
arithmetic, so encode -> decode gives the input bytes back.

The code is the square Cauchy matrix ``A[t, j] = 1/((c + t) ^ j)`` over
the ``c = pod_size`` destination blocks (the parity rows of
``rs.parity_matrix(c, 2c)``), every square submatrix of which is
invertible; ``coded_matrices`` returns it and its inverse. A decoder
needs only its own block: ``gf_decode_row`` combines the chunks with the
inverse row of its chip index. This is not a Pallas kernel in the
reference, so it is plain PyTorch here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from uda_tpu_torch.coding import gf256, rs
from uda_tpu_torch.ops.sort import i32, u32
from uda_tpu_torch.utils.errors import ConfigError

__all__ = ["coded_matrices", "gf_scale_words", "gf_matmul_words",
           "gf_decode_row", "MAX_CODED_BLOCKS"]

# the Cauchy points c+t and j must stay distinct inside GF(2^8):
# c + (c-1) <= 255 -> c <= 128
MAX_CODED_BLOCKS = 128


def coded_matrices(c: int) -> tuple[np.ndarray, np.ndarray]:
    """The (c, c) encode matrix for ``c`` destination blocks and its
    inverse, both uint8. ``c`` is the pod size: one coded chunk per
    member chip, full rank so any member can recover any block."""
    if not (2 <= c <= MAX_CODED_BLOCKS):
        raise ConfigError(f"coded exchange needs 2 <= pod_size <= "
                          f"{MAX_CODED_BLOCKS}, got {c}")
    enc = rs.parity_matrix(c, 2 * c)
    return enc, gf256.inv_matrix(enc)


@functools.lru_cache(maxsize=None)
def _mul_table(device: torch.device) -> torch.Tensor:
    """The 256x256 MUL table as uint8 on ``device``: row a, column b is
    ``a * b`` in GF(2^8)."""
    return torch.from_numpy(gf256.MUL.copy()).to(device)


def _lookup(x: torch.Tensor, coeff) -> torch.Tensor:
    """Bytewise ``coeff * x`` over 32-bit words: the words' four byte
    lanes (a uint8 view) index row ``coeff`` of the table (int64
    indices). Returns the product words as int32."""
    lanes = i32(x).contiguous().view(torch.uint8)
    return _mul_table(x.device)[coeff][lanes.to(torch.int64)].view(
        torch.int32)


def gf_scale_words(coeff: int, x: torch.Tensor) -> torch.Tensor:
    """``coeff * x`` in GF(2^8), bytewise over a uint32 tensor."""
    coeff = int(coeff)
    if coeff == 0:
        return u32(torch.zeros_like(i32(x)))
    if coeff == 1:
        return x
    return u32(_lookup(x, coeff))


def gf_matmul_words(mat: np.ndarray, blocks: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix action on stacked uint32 blocks: ``mat`` is an
    (r, k) uint8 matrix, ``blocks`` uint32[k, ...]; returns uint32[r, ...]
    whose row t is XOR_j mat[t, j] * blocks[j]."""
    out = torch.zeros((mat.shape[0], *blocks.shape[1:]), dtype=torch.int32,
                      device=blocks.device)
    for t in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            coeff = int(mat[t, j])
            if coeff:
                out[t] ^= _lookup(blocks[j], coeff)
    return u32(out)


def gf_decode_row(inv: np.ndarray, row_index, chunks: torch.Tensor
                  ) -> torch.Tensor:
    """One decoded block: ``XOR_t inv[row_index, t] * chunks[t]``, the
    decoder's own chip index ``row_index`` (an int or a 0-d tensor)
    selecting the inverse row; row 0 of the table is all zero, so a zero
    coefficient vanishes without a branch."""
    coeffs = torch.as_tensor(np.asarray(inv, np.int64),
                             device=chunks.device)[row_index]
    acc = torch.zeros(chunks.shape[1:], dtype=torch.int32,
                      device=chunks.device)
    for t in range(int(inv.shape[0])):
        acc ^= _lookup(chunks[t], coeffs[t])
    return u32(acc)
