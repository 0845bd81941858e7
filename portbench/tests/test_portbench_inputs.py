"""The benchmark's inputs: deterministic by seed, the same sizes for every
seed, and map outputs byte-identical to the port's own writer."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen, ifile

BIG_SEED = (1 << 31) + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, (1 << 64) + 3, -5])
def test_partitions_are_deterministic_by_seed(seed):
    a = gen.tera_partitions(seed, 3, 50, 32, 0)
    b = gen.tera_partitions(seed, 3, 50, 32, 0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    other = gen.tera_partitions(seed + 1, 3, 50, 32, 0)
    assert not np.array_equal(a[0], other[0])
    assert [p.shape for p in a] == [p.shape for p in other] == [(50, 104)] * 3


def test_partitions_are_sorted_framed_and_in_range():
    parts = gen.tera_partitions(3, 2, 400, 32, 5)
    for rec in parts:
        assert (rec[:, :3] == (11, 91, 10)).all() and (rec[:, 13] == 90).all()
        keys = [bytes(k) for k in rec[:, 3:13]]
        assert keys == sorted(keys)
        assert ((rec[:, 3] >> 3) == 5).all()


@pytest.mark.parametrize("reducers,partition", [(1, 0), (2, 1), (1 << 16, 77),
                                                (1 << 32, 12345)])
def test_partition_keys_hold_the_partitions_top_bits(reducers, partition):
    keys = gen.partition_keys(np.random.default_rng(1), 300, reducers,
                              partition)
    bits = reducers.bit_length() - 1
    head = keys[:, :4].copy().view(">u4").ravel().astype(np.uint64)
    assert (head >> np.uint64(32 - bits) == partition).all()


@pytest.mark.parametrize("reducers,partition", [(3, 0), (4, 4), (0, 0)])
def test_partition_keys_refuse_a_bad_partitioner(reducers, partition):
    with pytest.raises(ValueError):
        gen.partition_keys(np.random.default_rng(1), 3, reducers, partition)


def test_key_order_is_bytewise_and_stable():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 3, (500, 10), dtype=np.uint8)
    order = gen.key_order(keys)
    want = sorted(range(500), key=lambda i: (bytes(keys[i]), i))
    assert order.tolist() == want


@pytest.mark.parametrize("seed", [1, BIG_SEED])
def test_teragen_is_deterministic_by_seed(seed):
    a = gen.teragen(gen.card_generator(seed, "cpu"), 1000)
    b = gen.teragen(gen.card_generator(seed, "cpu"), 1000)
    c = gen.teragen(gen.card_generator(seed + 1, "cpu"), 1000)
    assert a.dtype == torch.uint32 and tuple(a.shape) == (1000, 26)
    ai, bi = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(ai, bi)
    assert not torch.equal(ai, c.view(torch.int32))
    assert (ai[:, 2] & 0xFFFF).eq(0).all()


def test_two_inputs_from_one_generator_differ():
    g = gen.card_generator(9, "cpu")
    a, b = gen.teragen(g, 64), gen.teragen(g, 64)
    assert not torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_map_outputs_equal_the_ports_writer(tmp_path):
    from uda_tpu_torch.mofserver import DirIndexResolver, MOFWriter

    parts = gen.tera_partitions(21, 3, 37, 4, 1)
    mids = ifile.write_tree(str(tmp_path / "mine"), "job", parts)
    writer = MOFWriter(str(tmp_path / "port"), "job")
    for mid, rec in zip(mids, parts):
        flat = rec.tobytes()
        writer.write(mid, [[(flat[o + 2:o + 13], flat[o + 13:o + 104])
                            for o in range(0, len(flat), 104)]])
    for mid in mids:
        for name in ("file.out", "file.out.index"):
            mine = (tmp_path / "mine" / "job" / mid / name).read_bytes()
            port = (tmp_path / "port" / "job" / mid / name).read_bytes()
            assert mine == port, (mid, name)
    rec = DirIndexResolver(str(tmp_path / "mine")).resolve("job", mids[1], 0)
    assert (rec.start_offset, rec.part_length) == (0, 37 * 104 + 2)


def test_map_output_of_several_partitions(tmp_path):
    parts = gen.tera_partitions(2, 3, 5)
    triples = ifile.write_map_output(str(tmp_path / "m"), parts)
    seg = 5 * 104 + 2
    assert triples == [(0, seg, seg), (seg, seg, seg), (2 * seg, seg, seg)]
    body = (tmp_path / "m" / "file.out").read_bytes()
    assert body == b"".join(p.tobytes() + b"\xff\xff" for p in parts)
