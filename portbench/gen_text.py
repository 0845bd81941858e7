"""Random-text map outputs after Hadoop's ``RandomTextWriter``
(``hadoop-mapreduce-examples``), as its output reaches one reduce task of
the examples' ``sort`` with Text keys and values: the same seed gives the
same bytes.

``RandomTextWriter`` writes each record as a key of ``minwordskey +
nextInt(maxwordskey - minwordskey)`` words and a value of ``minwordsvalue
+ nextInt(maxwordsvalue - minwordsvalue)`` words, each word drawn from its
word list and followed by one space. The word list here is a stand-in
drawn once from the configuration's ``dictionary`` entry. ``sort``'s
``HashPartitioner`` sends a key to reducer ``(hash & 0x7fffffff) %
reducers``, ``hash`` being ``WritableComparator.hashBytes`` of the Text's
content (1, then ``31 * h + byte`` in 32 bits, bytes signed); a map
keeps the records of the configuration's ``reduce_partition``, sorted
stably by key as the map-side sort leaves them, and frames them as IFile
records (vint key length, vint value length, the serialized Text key and
value: a vint of the content's length, then the content).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from portbench.gen import seed64

def dictionary(spec: dict) -> list:
    """``spec["words"]`` distinct lowercase ASCII words of
    ``spec["min_letters"]`` to ``spec["max_letters"]`` letters (uniform),
    drawn from ``spec["seed"]``."""
    rng = np.random.default_rng(seed64(spec["seed"]))
    words: dict = {}
    while len(words) < int(spec["words"]):
        n = int(rng.integers(int(spec["min_letters"]),
                             int(spec["max_letters"]) + 1))
        w = bytes(rng.integers(ord("a"), ord("z") + 1, n, dtype=np.uint8))
        words.setdefault(w, None)
    return list(words)


class WordTable:
    """The word list with one more entry, the empty word (index
    ``len(words)``), which pads a row of word indices. ``size[i]`` is word
    ``i`` and its space in bytes, ``rows[i]`` those bytes zero-padded;
    ``mul[i]`` and ``add[i]`` fold it into ``hashBytes``: ``h -> h *
    31^size[i] + hash(word + " ")``, modulo 2^32 (1 and 0 for the empty
    word)."""

    def __init__(self, words: list):
        spaced = [w + b" " for w in words] + [b""]
        self.size = np.array([len(w) for w in spaced], np.int64)
        self.rows = np.zeros((len(spaced), int(self.size.max())), np.uint8)
        for i, w in enumerate(spaced):
            self.rows[i, :len(w)] = np.frombuffer(w, np.uint8)
        self.mul = np.array([pow(31, len(w), 1 << 32) for w in spaced],
                            np.uint32)
        add = []
        for w in spaced:
            h = 0
            for b in w:
                h = (31 * h + (b - 256 if b > 127 else b)) % (1 << 32)
            add.append(h)
        self.add = np.array(add, np.uint32)

    @property
    def empty(self) -> int:
        return self.size.size - 1

    def hash(self, words: np.ndarray) -> np.ndarray:
        """``hashBytes`` of the text of each row of word indices (uint32
        arithmetic wraps modulo 2^32)."""
        h = np.ones(words.shape[0], np.uint32)
        for j in range(words.shape[1]):
            w = words[:, j]
            h = h * self.mul[w] + self.add[w]
        return h

    def order(self, words: np.ndarray) -> np.ndarray:
        """The stable order of the texts of rows of word indices, bytewise
        with the shorter first: the texts zero-padded to one width, whose
        NUL-free bytes then compare as the texts do."""
        n, per = words.shape
        width = self.rows.shape[1] * per
        mat = np.zeros(n * width, np.uint8)
        self.place(mat, words.ravel(), np.full(n, per),
                   np.arange(n) * width)
        return np.argsort(mat.view(f"S{width}"), kind="stable")

    def place(self, out: np.ndarray, words: np.ndarray, count: np.ndarray,
              at: np.ndarray) -> None:
        """Write texts into ``out``: text i, the next ``count[i]`` words of
        ``words`` (a flat run of indices), at ``at[i]``; one numpy move a
        word size."""
        size = self.size[words]
        before = np.cumsum(size) - size
        first = np.cumsum(count) - count
        dst = before + np.repeat(at - before[first], count)
        order = np.argsort(size.astype(np.uint8), kind="stable")
        bounds = np.flatnonzero(np.diff(size[order], prepend=-1))
        for a, b in zip(bounds, np.append(bounds[1:], order.size)):
            pick = order[a:b]
            n = int(size[pick[0]])
            if n:
                view = sliding_window_view(out, n, writeable=True)
                view[dst[pick]] = self.rows[words[pick], :n]


def vint_bytes(values: np.ndarray) -> tuple:
    """Hadoop's ``WritableUtils.writeVInt`` of non-negative values below
    2^16: uint8[n, 3] (each row's first ``size`` bytes) and the sizes."""
    v = np.asarray(values, np.int64)
    if v.size and (v.min() < 0 or v.max() >= 1 << 16):
        raise ValueError("a length outside [0, 2^16)")
    out = np.zeros((v.size, 3), np.uint8)
    one = v <= 127
    two = ~one & (v < 256)
    three = v >= 256
    out[one, 0] = v[one]
    out[two, 0] = 0x8F          # -113: one byte follows
    out[two, 1] = v[two]
    out[three, 0] = 0x8E        # -114: two bytes follow
    out[three, 1] = v[three] >> 8
    out[three, 2] = v[three] & 0xFF
    return out, np.where(one, 1, np.where(two, 2, 3))


def _place_vints(out: np.ndarray, values: np.ndarray,
                 at: np.ndarray) -> np.ndarray:
    """Write the vint of each value at ``at``; returns their sizes."""
    vb, size = vint_bytes(values)
    for j in range(3):
        live = size > j
        out[at[live] + j] = vb[live, j]
    return size


def frame(table: WordTable, keys: np.ndarray, values: np.ndarray,
          vcount: np.ndarray) -> np.ndarray:
    """IFile records of Text keys and values, one uint8 buffer: ``keys``
    rows of word indices (padded with the empty word), ``values`` the
    values' words one after the other, ``vcount`` words a value."""
    klen = table.size[keys].sum(axis=1)
    vsize = table.size[values]
    vends = np.cumsum(vcount)
    csum = np.concatenate([[0], np.cumsum(vsize)])
    vlen = csum[vends] - csum[vends - vcount]
    ks, vs = vint_bytes(klen)[1], vint_bytes(vlen)[1]
    rks, rvs = vint_bytes(ks + klen)[1], vint_bytes(vs + vlen)[1]
    rec = rks + rvs + ks + klen + vs + vlen
    start = np.cumsum(rec) - rec
    out = np.empty(int(rec.sum()), np.uint8)
    _place_vints(out, ks + klen, start)
    _place_vints(out, vs + vlen, start + rks)
    kat = start + rks + rvs
    _place_vints(out, klen, kat)
    kat = kat + ks
    table.place(out, keys.ravel(), np.full(keys.shape[0], keys.shape[1]),
                kat)
    vat = kat + klen
    _place_vints(out, vlen, vat)
    vat = vat + vs
    table.place(out, values, vcount, vat)
    return out


def text_partitions(seed: int, config: dict) -> list:
    """Each map's partition for the configuration's reduce task, as a map
    leaves it: uint8[bytes] of IFile records sorted stably by key.
    ``config`` gives ``maps``, ``records_per_map``, ``reducers``,
    ``reduce_partition``, ``randomtextwriter`` (the four word counts) and
    ``dictionary``."""
    table = WordTable(dictionary(config["dictionary"]))
    rtw = config["randomtextwriter"]
    kmin, kmax = int(rtw["minwordskey"]), int(rtw["maxwordskey"])
    vmin, vmax = int(rtw["minwordsvalue"]), int(rtw["maxwordsvalue"])
    n = int(config["records_per_map"])
    reducers, part = int(config["reducers"]), int(config["reduce_partition"])
    rng = np.random.default_rng(seed64(seed))
    parts = []
    for _ in range(int(config["maps"])):
        count = kmin + rng.integers(0, kmax - kmin, n)
        words = rng.integers(0, table.empty, (n, kmax - 1))
        words[np.arange(kmax - 1)[None, :] >= count[:, None]] = table.empty
        h = table.hash(words)
        keys = words[(h & np.uint32(0x7FFFFFFF)) % np.uint32(reducers)
                     == part]
        keys = keys[table.order(keys)]
        vcount = vmin + rng.integers(0, vmax - vmin, keys.shape[0])
        values = rng.integers(0, table.empty, int(vcount.sum()))
        parts.append(frame(table, keys, values, vcount))
    return parts
