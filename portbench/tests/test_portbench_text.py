"""The Text reduce cell (``reduce-text-varlen``) on the CPU at a test size:
the random-text generator (``gen_text.py``) against Hadoop's rules, the
plain reference (``reference/reduce_text.py``) on hand-made streams, and
the driver end to end, correct and reading the tie-fix's timer and
counters. The readers read nothing from a program without the tie-fix.

Importing this file gives the configuration its test size in
``conftest.TINY_CONFIG`` (as ``portbench/conftest.py`` does the 4-node
one), so every test of the benchmark that makes a root through
``make_root`` in the same test run runs the cell at that size."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import gen_text, harness
from portbench.reference import reduce_text as ref
from portbench.tests.conftest import (BENCH, REPO, TINY_CONFIG, make_root,
                                      run_cell)

CELL = "reduce-text-varlen"
CONFIG = "randomtext-sort-reduce"
READERS = ("tiefix_s_per_GB.text", "tiefix_rows_pct.text")

# 4 maps of 8000 drawn records, about 250 kept a map: enough equal
# 16-byte prefixes that the control's order differs on every seed
TINY_CONFIG.setdefault(CONFIG, {"maps": 4, "records_per_map": 8000})


def _config(**over) -> dict:
    conf = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    data = json.loads((REPO / conf["file"]).read_text())
    data.update(TINY_CONFIG[CONFIG], **over)
    return data


def _java_hash(content: bytes) -> int:
    """``WritableComparator.hashBytes``, one byte at a time."""
    h = 1
    for b in content:
        h = (31 * h + (b - 256 if b > 127 else b)) & 0xFFFFFFFF
    return h


def test_the_generator_follows_hadoops_rules():
    conf = _config()
    parts = gen_text.text_partitions((1 << 33) + 3, conf)
    again = gen_text.text_partitions((1 << 33) + 3, conf)
    assert all(np.array_equal(a, b) for a, b in zip(parts, again))
    other = gen_text.text_partitions(5, conf)
    assert not all(np.array_equal(a, b) for a, b in zip(parts, other))
    words = set(gen_text.dictionary(conf["dictionary"]))
    assert len(words) == 1000
    rtw = conf["randomtextwriter"]
    for part in parts:
        recs, end = ref.records(part.tobytes())
        assert end == part.size and len(recs) > 150
        keys = [k for k, _ in recs]
        # each map's partition is sorted, every key is reduce 0's
        assert keys == sorted(keys)
        assert all((_java_hash(k) & 0x7FFFFFFF) % conf["reducers"]
                   == conf["reduce_partition"] for k in keys)
        for key, rec in recs:
            value = _value(rec)
            for text, low, high in ((key, "minwordskey", "maxwordskey"),
                                    (value, "minwordsvalue",
                                     "maxwordsvalue")):
                tw = text.split(b" ")
                assert tw[-1] == b"" and set(tw[:-1]) <= words
                assert rtw[low] <= len(tw) - 1 < rtw[high]


def _value(rec: bytes) -> bytes:
    """The value's content of one framed record."""
    klen, at = ref.read_vint(rec, 0)
    vlen, at = ref.read_vint(rec, at)
    tlen, vat = ref.read_vint(rec, at + klen)
    assert at + klen + vlen == len(rec) == vat + tlen
    return rec[vat:]


@pytest.mark.parametrize("n", [0, 1, 127, 128, 255, 256, 1400, 65535])
def test_vints_read_back(n):
    raw, size = gen_text.vint_bytes(np.array([n]))
    value, end = ref.read_vint(bytes(raw[0, :size[0]]), 0)
    assert (value, end) == (n, size[0])


def _stream(recs: list) -> bytes:
    """Framed records of (key content, value content) pairs."""
    out = []
    for k, v in recs:
        kv, ks = gen_text.vint_bytes(np.array([len(k)]))
        vv, vs = gen_text.vint_bytes(np.array([len(v)]))
        kser = bytes(kv[0, :ks[0]]) + k
        vser = bytes(vv[0, :vs[0]]) + v
        rk, rks = gen_text.vint_bytes(np.array([len(kser)]))
        rv, rvs = gen_text.vint_bytes(np.array([len(vser)]))
        out.append(bytes(rk[0, :rks[0]]) + bytes(rv[0, :rvs[0]]) + kser
                   + vser)
    return b"".join(out)


PRE = b"abcdefghijklmnop"          # 16 bytes


def _parts() -> list:
    """Two maps: equal 16-byte prefixes across them, a key of exactly 16
    bytes, equal long keys in both, values of 1 to 300 bytes."""
    a = [(PRE, b"a0"), (PRE + b" b", b"a1" * 150), (PRE + b"zz", b"a2"),
         (PRE + b"zz", b"a3")]
    b = [(b"a", b"b0"), (PRE + b" a", b"b1"), (PRE + b"y", b"b2"),
         (PRE + b"zz", b"b3")]
    return [np.frombuffer(_stream(sorted(p, key=lambda kv: kv[0])), np.uint8)
            for p in (a, b)]


def test_the_reference_merges_stably_by_whole_content():
    want = ref.merged_records(_parts())
    assert [ref.records(r)[0][0][0] for r in want] == [
        b"a", PRE, PRE + b" a", PRE + b" b", PRE + b"y", PRE + b"zz",
        PRE + b"zz", PRE + b"zz"]
    # equal keys in map order, then row order
    assert [_value(r) for r in want[-3:]] == [b"a2", b"a3", b"b3"]
    # the control orders the keys past 16 bytes by their length, then
    # in map order
    control = ref.control_records(_parts())
    assert [ref.records(r)[0][0][0] for r in control] == [
        b"a", PRE, PRE + b"y", PRE + b" b", PRE + b"zz", PRE + b"zz",
        PRE + b" a", PRE + b"zz"]
    assert ref.records_out_of_place(want, ref.stream_of(control)) > 0


def test_the_reference_counts_what_is_out_of_place():
    want = ref.merged_records(_parts())
    good = ref.stream_of(want)
    assert ref.records_out_of_place(want, good) == 0
    swapped = list(want)
    swapped[2], swapped[3] = swapped[3], swapped[2]
    assert ref.records_out_of_place(want, ref.stream_of(swapped)) == 2
    # a record missing: it and every later one, and the length
    missing = ref.stream_of(want[:3] + want[4:])
    assert ref.records_out_of_place(want, missing) == len(want) - 3 + 1
    assert ref.records_out_of_place(want, good[:-2]) == 1       # no EOF
    assert ref.records_out_of_place(want, good + b"\0") == 1    # a byte past
    assert ref.records_out_of_place(want, good[:-5]) == 2       # cut short
    assert ref.records_out_of_place(want, b"") == len(want) + 1


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


def test_a_sound_run_is_correct_and_reads_the_tiefix(root):
    rc, line = run_cell(root, CELL, seed=(1 << 33) + 11, seconds=0.5,
                        trace=1)
    assert rc == 0 and line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert line["metrics"]["tiefix_s_per_GB.text"]["value"] > 0
    assert 0 < line["metrics"]["tiefix_rows_pct.text"]["value"] < 100


def test_the_control_is_not_correct_on_every_seed(root, capsys):
    from portbench import control

    rc = control.main(["--workload", CELL, "--seeds", "1,2,3,4",
                       "--seconds", "0.2"], root=root, device="cpu")
    assert rc == 0, capsys.readouterr().out


def test_the_tiefix_readers_are_silent_without_the_tiefix():
    run = SimpleNamespace()
    task = {"wall_s": 3.0, "fetch_s": 1.0, "merge_s": 0.5, "bytes": 5e8}
    timers = {"emit_tiefix_time": 0.25, "fetch_time": 1.0}
    counters = {"merge.records": 400.0, "merge.tiefix_groups": 30.0,
                "merge.tiefix_rows": 100.0}
    full = dict(task, timers=timers, counters=counters)
    reads = [harness.load_module(REPO, "metrics", n).read for n in READERS]
    assert [r(run, {"tasks": [full] * 2}) for r in reads] == [0.5, 25.0]
    # the parent's program: no tie-fix timer and no tie-fix counters
    parent = dict(task, timers={"fetch_time": 1.0},
                  counters={"merge.records": 400.0})
    for read in reads:
        assert read(run, {"tasks": [parent]}) is None
        assert read(run, {"tasks": [task]}) is None
        assert read(run, {"tasks": []}) is None
        assert read(run, {"sorted_records": 10}) is None
