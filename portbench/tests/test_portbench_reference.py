"""The plain references against tiny sorts and merges worked out in
Python, and their controls against the references."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import reduce as rreduce
from portbench.reference import sort as rsort


def _words(keys: list, seed: int = 0) -> torch.Tensor:
    """uint32[n, 26] records with the given 10-byte keys, random values."""
    n = len(keys)
    w = gen.teragen(gen.card_generator(seed, "cpu"), n).view(torch.int32)
    for i, k in enumerate(keys):
        padded = k + b"\0\0"
        w[i, :3] = torch.tensor(np.frombuffer(padded, ">u4").astype(np.int64)
                                .astype(np.uint32).view(np.int32))
    return w.view(torch.uint32)


def _key_bytes(words: torch.Tensor) -> list:
    w = words.view(torch.int32)[:, :3].numpy().astype(">u4")
    return [r.tobytes()[:10] for r in w]


def test_sort_reference_is_a_stable_whole_key_sort():
    rng = np.random.default_rng(5)
    keys = [bytes(rng.integers(0, 2, 10, dtype=np.uint8)) for _ in range(300)]
    keys[7] = b"\xff" * 10
    words = _words(keys)
    order = rsort.stable_order(words)
    want = sorted(range(300), key=lambda i: (keys[i], i))
    assert order.tolist() == want
    out = words.view(torch.int32)[order].view(torch.uint32)
    assert rsort.records_out_of_place(words, out) == 0


def test_sort_reference_counts_what_is_out_of_place():
    words = gen.teragen(gen.card_generator(3, "cpu"), 2000)
    good = words.view(torch.int32)[rsort.stable_order(words)]
    bad = good.clone()
    bad[[5, 9]] = bad[[9, 5]]
    assert rsort.records_out_of_place(words, bad.view(torch.uint32)) == 2
    bad = good.clone()
    bad[100, 20] ^= 1
    assert rsort.records_out_of_place(words, bad.view(torch.uint32)) == 1
    assert rsort.records_out_of_place(words, words[:1000]) == 2000
    assert rsort.records_out_of_place(words, None) == 2000


def test_sort_control_fails_where_first_words_tie():
    words = gen.teragen(gen.card_generator(8, "cpu"), 1 << 18)
    w0 = words.view(torch.int32)[:, 0]
    assert w0.unique().numel() < w0.numel()
    assert rsort.records_out_of_place(words, rsort.control_sort(words)) > 0


def test_reduce_reference_is_a_stable_bytewise_merge():
    parts = gen.tera_partitions(4, 5, 60, 1 << 24, 3)
    got = rreduce.merged_records(parts)
    rows = [(p.tobytes()[o + 3:o + 13], m, o) for m, p in enumerate(parts)
            for o in range(0, p.size, 104)]
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    want = b"".join(parts[m].tobytes()[o:o + 104] for _, m, o in rows)
    assert got.tobytes() == want
    stream = rreduce.stream_of(got)
    assert stream.endswith(b"\xff\xff") and len(stream) == 300 * 104 + 2
    assert rreduce.records_out_of_place(got, stream) == 0


def test_reduce_reference_counts_what_is_out_of_place():
    parts = gen.tera_partitions(6, 3, 40)
    want = rreduce.merged_records(parts)
    stream = bytearray(rreduce.stream_of(want))
    assert rreduce.records_out_of_place(want, bytes(stream[:-2])) == 1
    assert rreduce.records_out_of_place(want, bytes(stream) + b"x") == 1
    stream[500] ^= 0xFF
    assert rreduce.records_out_of_place(want, bytes(stream)) == 1
    half = rreduce.stream_of(want[:60])
    assert rreduce.records_out_of_place(want, half) == 61


def test_reduce_reference_refuses_another_framing():
    parts = gen.tera_partitions(6, 2, 10)
    parts[1][3, 0] = 12
    with pytest.raises(ValueError):
        rreduce.merged_records(parts)


def test_reduce_control_fails_where_key_heads_tie():
    parts = gen.tera_partitions(9, 4, 500, 1 << 16, 0)
    want = rreduce.merged_records(parts)
    ctl = rreduce.stream_of(rreduce.control_records(parts))
    assert rreduce.records_out_of_place(want, ctl) > 0
