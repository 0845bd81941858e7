"""The port's framed emission (uda_tpu_torch.merger.emitter.FramedEmitter)
against the JAX package's on the same framed bytes: the consumer's block
list and the returned count of ``emit_framed`` at every piece size about
the block size and of ``emit_batch`` at every block size about the stream's
length; the previous block left intact through the next call (the double
buffer); and every arena slot free again after a consumer raises mid-stream.
Tolerance 0: all of it is bytes and integers."""

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.merger import emitter as jemitter
from uda_tpu.utils.ifile import EOF_MARKER, crack, write_records
from uda_tpu_torch.merger import emitter as temitter
from uda_tpu_torch.utils.ifile import RecordBatch

BLOCK = 512


def _pieces(size):
    """A framed stream cut into pieces: 5 of ``size`` bytes then the EOF
    marker, or (``"small"``) a run of pieces of 0 to 40 bytes making up
    several blocks."""
    rng = np.random.default_rng(3)
    if size == "small":
        sizes = rng.integers(0, 41, 90).tolist()
    else:
        sizes = [size] * 5
    return [rng.bytes(n) for n in sizes] + [EOF_MARKER]


def _blocks(emit, *args):
    """(returned count, the consumer's blocks) of one emission."""
    blocks = []
    n = emit(*args, lambda mv: blocks.append(bytes(mv)))
    return n, blocks


@pytest.mark.parametrize("size", [0, 1, BLOCK - 1, BLOCK, BLOCK + 1,
                                  3 * BLOCK + 7, "small"])
def test_emit_framed_blocks_match_reference(size):
    pieces = _pieces(size)
    port = temitter.FramedEmitter(BLOCK)
    want = _blocks(jemitter.FramedEmitter(BLOCK).emit_framed, iter(pieces))
    got = _blocks(port.emit_framed, iter(pieces))
    assert got == want
    assert b"".join(got[1]) == b"".join(pieces) and got[0] == len(
        b"".join(pieces))
    # pieces that are not bytes objects: the same blocks
    views = [memoryview(bytearray(p)) for p in pieces]
    assert _blocks(port.emit_framed, iter(views)) == want
    assert port.arena.free_slots == port.arena.num_slots


@pytest.mark.parametrize("block", ["one", "total-1", "total", "total+1",
                                   "third", "large"])
def test_emit_batch_blocks_match_reference(monkeypatch, block):
    """``emit_batch`` frames in chunks of 7 records (both packages) and
    hands the chunks on through ``emit_framed``: the blocks are the
    reference's at block sizes about the stream's length."""
    monkeypatch.setattr(jemitter, "FRAME_CHUNK_RECORDS", 7)
    monkeypatch.setattr(temitter, "FRAME_CHUNK_RECORDS", 7)
    rng = np.random.default_rng(8)
    recs = [(rng.bytes(int(rng.integers(0, 12))),
             rng.bytes(int(rng.integers(0, 200)))) for _ in range(40)]
    data = write_records(recs)
    total = len(data)
    size = {"one": 1, "total-1": total - 1, "total": total,
            "total+1": total + 1, "third": (total - 7) // 3,
            "large": 1 << 20}[block]
    ref = crack(data)
    port = RecordBatch(ref.data.copy(), ref.key_off.copy(),
                       ref.key_len.copy(), ref.val_off.copy(),
                       ref.val_len.copy())
    want = _blocks(jemitter.FramedEmitter(size).emit_batch, ref)
    got = _blocks(temitter.FramedEmitter(size).emit_batch, port)
    assert got == want
    assert b"".join(got[1]) == data and got[0] == total


def test_emit_framed_keeps_the_previous_block_through_the_next_call():
    """A pipelined consumer may still read the prior block while it is
    handed the next: its slot is released one call late."""
    pieces = _pieces(3 * BLOCK + 7)
    seen, prev = [], []

    def consumer(mv):
        if prev:
            assert bytes(prev[0]) == seen[-1]
        seen.append(bytes(mv))
        prev[:] = [mv]

    emitter = temitter.FramedEmitter(BLOCK)
    assert emitter.emit_framed(iter(pieces), consumer) == \
        len(b"".join(pieces))
    assert len(seen) == -(-len(b"".join(pieces)) // BLOCK)


@pytest.mark.parametrize("at", [0, 1, 3])
def test_consumer_error_mid_emit_framed_frees_every_slot(at):
    pieces = _pieces(BLOCK + 1)
    calls = []

    def consumer(mv):
        calls.append(len(mv))
        if len(calls) > at:
            raise RuntimeError("consumer failed")

    emitter = temitter.FramedEmitter(BLOCK)
    with pytest.raises(RuntimeError, match="consumer failed"):
        emitter.emit_framed(iter(pieces), consumer)
    assert len(calls) == at + 1
    assert emitter.arena.free_slots == emitter.arena.num_slots
    # the emitter serves the next stream from the same arena
    assert _blocks(emitter.emit_framed, iter(pieces)) == _blocks(
        jemitter.FramedEmitter(BLOCK).emit_framed, iter(pieces))
