"""The plain reference of the sort cells, in plain PyTorch.

TeraSort records are ``uint32[n, 26]`` rows whose words 0-2 hold the
10-byte key big-endian (then 2 zero pad bytes). The configuration states
a stable sort of whole records by the whole key, unsigned and bytewise,
equal keys in arrival order. The reference sorts by a least-significant-
first pair of stable sorts (word 2, then words 0-1 packed into one
signed 64-bit value whose order is their unsigned order) and compares
the program's output with the input moved by that order, in blocks of
rows. The control sorts by word 0 alone: the order a 32-bit key would
give, which breaks the stated whole-key order wherever two keys share
their first 4 bytes.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 24


def _u64(words: torch.Tensor, col: int) -> torch.Tensor:
    """Column ``col`` of 32-bit words as int64 values in [0, 2^32)."""
    return words.view(torch.int32)[:, col].to(torch.int64) & 0xFFFFFFFF


def stable_order(words: torch.Tensor) -> torch.Tensor:
    """The stable order of the records by their whole key."""
    _, order = torch.sort(_u64(words, 2), stable=True)
    hi = ((_u64(words, 0) - (1 << 31)) << 32) | _u64(words, 1)
    _, second = torch.sort(hi[order], stable=True)
    return order[second]


def control_order(words: torch.Tensor) -> torch.Tensor:
    """The control's order: stable by the key's first 4 bytes alone."""
    _, order = torch.sort(_u64(words, 0), stable=True)
    return order


def control_sort(words: torch.Tensor) -> torch.Tensor:
    """The control in the program's place: the records moved by
    ``control_order``."""
    return words.view(torch.int32)[control_order(words)].view(words.dtype)


def records_out_of_place(words: torch.Tensor, out) -> int:
    """How many of the n sorted records the program's ``out`` does not
    hold in their place: rows that differ from the input moved by the
    stable whole-key order, and every row of an output of another shape
    or type."""
    n = words.shape[0]
    if (not isinstance(out, torch.Tensor) or out.dtype != words.dtype
            or tuple(out.shape) != tuple(words.shape)
            or out.device != words.device):
        return n
    order = stable_order(words)
    src = words.view(torch.int32)
    got = out.view(torch.int32)
    bad = 0
    for a in range(0, n, BLOCK_ROWS):
        b = min(n, a + BLOCK_ROWS)
        want = src[order[a:b]]
        bad += int((got[a:b] != want).any(dim=1).sum())
        del want
    return bad


def control(state, run) -> None:
    """Put the control in the program's place in a sort driver's state."""
    state.call = control_sort
