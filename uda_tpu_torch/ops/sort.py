"""Engine names, engine routing and the plain sort operations of the port.

Counterpart of ``uda_tpu/ops/sort.py``: the engine-name tuples,
``resolve_sort_path`` / ``route_engine`` with a device argument (the
latter with the tune-cache consult and the small-batch steering),
``apply_perm_chunked`` and ``stable_lex_argsort``, the port's stable
lexicographic sort permutation over uint32 key words (the counterpart of
``lax.sort(..., is_stable=True)``, behind the ``carry``, ``gather``,
``gather2`` and ``carrychunk`` engines), and the sorts over packed record
keys the merge uses (``sort_permutation``, ``merge_runs``,
``sort_records_fixed``).

Torch's ``uint32`` support is thin (on the CPU it has no ``<``, ``gather``
or ``index_select`` for it, and the card is not assumed to have more), so
the port compares int64 copies of the words and fills, copies, joins and
moves uint32 data through ``int32`` views, which keep the bits
(:func:`i32`, :func:`u32`).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from uda_tpu_torch.device import resolve_device
from uda_tpu_torch.ops.packing import PackedKeys
from uda_tpu_torch.utils import tuncache

__all__ = ["resolve_sort_path", "route_engine", "apply_perm_chunked",
           "stable_lex_argsort", "take_cols", "i32", "u32", "words_of",
           "fill_words", "sort_permutation", "concat_packed", "merge_runs",
           "sort_records_fixed", "LANES_ENGINES", "FLYOFF_ENGINES",
           "BENCH_FLYOFF", "ALL_SORT_PATHS", "DEFAULT_CHUNK_COLS",
           "DEPLOYED_SORT_PATH", "GATHER_BOUND_ENGINES", "SMALL_BATCH_ROWS",
           "FOLDED_KEY_ROWS", "cache_backend"]

# The engine knobs, under the reference's names, read once at import.
DEFAULT_CHUNK_COLS = int(os.environ.get("UDA_TPU_CHUNK_COLS", "6"))
DEPLOYED_SORT_PATH = os.environ.get("UDA_TPU_SORT_PATH", "")

# The engine names (uda_tpu/ops/sort.py:81-84). LANES_ENGINES run the
# kernel cascade (ops/pallas_sort.py, ops/pallas_fold.py); the rest compute
# a stable sort permutation and move the records by it.
LANES_ENGINES = ("lanes", "lanes2", "keys8", "keys8f")
FLYOFF_ENGINES = ("lanes", "lanes2", "keys8", "gather2", "carrychunk")
BENCH_FLYOFF = FLYOFF_ENGINES + ("keys8f",)
ALL_SORT_PATHS = ("carry", "gather") + BENCH_FLYOFF

# Engines whose payload movement is one or more global gathers, and the
# batch size below which "auto" steers them to "carrychunk" on the
# accelerator (uda_tpu/ops/sort.py:86-93: on the TPU the gather is
# latency-bound below 2^20 rows). On the card the rule is kept as it is;
# chip_smoke.py phase 5 times it.
GATHER_BOUND_ENGINES = ("gather", "gather2", "keys8", "keys8f")
SMALL_BATCH_ROWS = 1 << 20

# The key rows the slim cascade (keys8f: K3/K4 on uint32[4, m], the
# arrival index in row 3) holds; keys8's 8-row layout holds up to 7.
FOLDED_KEY_ROWS = 3

_I32_BIAS = 1 << 31


def resolve_sort_path(path: str, lanes_ok: bool = False,
                      device=None, key_rows: "int | None" = None) -> str:
    """Resolve an engine name. ``"auto"`` takes a deployed
    ``UDA_TPU_SORT_PATH`` the caller can run, else the device's default:
    ``carry`` on the CPU (as the reference); on the card the kernel
    cascade that fits the caller's key rows, ``keys8f`` (K3/K4 on 4 rows)
    where they fit its 3, else ``keys8`` (K2/K1 on 8 rows), and
    ``gather`` for a caller that runs no lanes engine. ``lanes_ok``
    admits LANES_ENGINES for callers that implement them. ``key_rows``
    is the number of key rows the caller sorts (``keys8_sort_perm``'s
    rows); over :data:`FOLDED_KEY_ROWS` it turns a deployed or built-in
    ``keys8f`` into ``keys8``; None asks for no adaptation. An explicit
    path is always honoured."""
    valid = _valid_paths(lanes_ok)
    if path == "auto":
        if DEPLOYED_SORT_PATH:
            if DEPLOYED_SORT_PATH not in ALL_SORT_PATHS:
                raise ValueError(
                    f"UDA_TPU_SORT_PATH={DEPLOYED_SORT_PATH!r} is not a "
                    f"known sort path {ALL_SORT_PATHS}")
            if DEPLOYED_SORT_PATH in valid:
                return _fit_key_rows(DEPLOYED_SORT_PATH, key_rows)
        if resolve_device(device).type == "cpu":
            path = "carry"
        else:
            path = _fit_key_rows("keys8f", key_rows) if lanes_ok \
                else "gather"
    if path not in valid:
        raise ValueError(f"unknown sort path {path!r}")
    return path


def _fit_key_rows(engine: str, key_rows: "int | None") -> str:
    """``keys8`` for a ``keys8f`` whose caller sorts more key rows than
    the slim layout holds; any other engine as it is."""
    if engine == "keys8f" and key_rows is not None \
            and key_rows > FOLDED_KEY_ROWS:
        return "keys8"
    return engine


def _valid_paths(lanes_ok: bool) -> tuple:
    return (ALL_SORT_PATHS if lanes_ok
            else tuple(p for p in ALL_SORT_PATHS if p not in LANES_ENGINES))


def cache_backend(device=None) -> str:
    """The backend coordinate of a tune-cache key, under the names JAX
    uses: ``cpu`` on the CPU, ``gpu`` on the card, so a cache file written
    by the reference routes the port the same way."""
    return "cpu" if resolve_device(device).type == "cpu" else "gpu"


def _cached_engine(n_rows: int, lanes_ok: bool, device=None) -> "str | None":
    """The tune-cache consult for "auto" routing (``utils/tuncache``): a
    fly-off winner persisted per (backend, row bucket, lanes capability)
    by ``python -m uda_tpu_torch.tools.tune_probe``.
    None (the built-in default) on a cold cache, an unreadable file, or a
    winner this caller cannot run: a stale or hand-edited cache can never
    force an invalid engine onto a sort surface."""
    key = (f"{cache_backend(device)}|rows{tuncache.rows_bucket(n_rows)}"
           f"|lanes{int(lanes_ok)}")
    rec = tuncache.tune_cache.lookup("sort.engine", key)
    if rec is None:
        return None
    engine = (rec.get("winner") or {}).get("engine")
    return engine if engine in _valid_paths(lanes_ok) else None


def route_engine(n_rows: int, path: str = "auto", lanes_ok: bool = False,
                 device=None, key_rows: "int | None" = None) -> str:
    """Batch-size-aware engine routing, the resolution entry of the
    production sort surfaces (``models/terasort.single_chip_sort``, the
    mesh's local sort). ``path`` resolves like :func:`resolve_sort_path`;
    for "auto" with no deployed ``UDA_TPU_SORT_PATH`` the persisted tune
    cache is consulted first (env > cache > built-in; a cold cache routes
    as the built-in default). A deployed, cached or built-in ``keys8f``
    becomes ``keys8`` where ``key_rows`` is over
    :data:`FOLDED_KEY_ROWS`. Then, on the card, a batch below
    :data:`SMALL_BATCH_ROWS` is steered from :data:`GATHER_BOUND_ENGINES`
    to "carrychunk", deployed and cached winners alike (the card takes
    the accelerator's role of the reference's rule). An explicit path is
    always honoured."""
    if path != "auto":
        return resolve_sort_path(path, lanes_ok, device)
    resolved = resolve_sort_path("auto", lanes_ok, device, key_rows)
    if not DEPLOYED_SORT_PATH:
        cached = _cached_engine(n_rows, lanes_ok, device)
        if cached is not None:
            resolved = _fit_key_rows(cached, key_rows)
    if (n_rows < SMALL_BATCH_ROWS and resolve_device(device).type != "cpu"
            and resolved in GATHER_BOUND_ENGINES):
        return "carrychunk"
    return resolved


def i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 view of 32-bit words (same bits)."""
    return x.view(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 view of 32-bit words (same bits)."""
    return x.view(torch.uint32)


def words_of(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 words, exactly."""
    return u32(torch.where(values >= _I32_BIAS, values - (1 << 32),
                           values).to(torch.int32))


def fill_words(shape, device, value: int = 0) -> torch.Tensor:
    """A uint32 tensor of ``shape`` filled with ``value`` (< 2^32)."""
    fill = value - (1 << 32) if value >= _I32_BIAS else value
    return u32(torch.full(shape, fill, dtype=torch.int32, device=device))


def take_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` for 32-bit words, through an int32 view."""
    return i32(x)[..., idx].view(x.dtype)


def _as_i64(word: torch.Tensor) -> torch.Tensor:
    """32-bit words (or int64 values in [0, 2^32)) as int64 values in
    [0, 2^32)."""
    if word.dtype in (torch.uint32, torch.int32):
        word = i32(word)
    return word.to(torch.int64) & 0xFFFFFFFF


def _packed_keys(words: Sequence[torch.Tensor]) -> list:
    """Pack uint32 words (most significant first) two to an int64 whose
    signed order is their lexicographic order: (hi - 2^31) * 2^32 + lo."""
    keys = []
    for i in range(0, len(words), 2):
        hi = _as_i64(words[i])
        if i + 1 == len(words):
            keys.append(hi)
        else:
            keys.append((hi - _I32_BIAS) * (1 << 32) + _as_i64(words[i + 1]))
    return keys


def stable_lex_argsort(words: Sequence[torch.Tensor],
                       dim: int = -1) -> torch.Tensor:
    """Stable sort permutation of records by their key words, lexicographic
    and unsigned, most significant word first: equal keys keep arrival
    order. ``words``: uint32 tensors of one shape; the sort runs along
    ``dim`` (batched over the other dimensions). Returns int64 indices."""
    order = None
    for key in reversed(_packed_keys(words)):
        if order is not None:
            key = torch.gather(key, dim, order)
        _, idx = torch.sort(key, dim=dim, stable=True)
        order = idx if order is None else torch.gather(order, dim, idx)
    return order


def apply_perm_chunked(perm: torch.Tensor, cols: Sequence[torch.Tensor],
                       chunk_cols: "int | None" = None) -> list:
    """``out[c][j] == cols[c][perm[j]]``, moving ``chunk_cols`` columns
    (default ``UDA_TPU_CHUNK_COLS``) per gather. The reference inverts the
    permutation and re-sorts chunks because XLA's variadic-sort compile
    time forbids wide sorts on the TPU; on the card a gather is the
    port."""
    if chunk_cols is None:
        chunk_cols = DEFAULT_CHUNK_COLS
    out: list = []
    for base in range(0, len(cols), chunk_cols):
        chunk = torch.stack([i32(c) for c in cols[base:base + chunk_cols]])
        out.extend(c.view(cols[0].dtype) for c in chunk[:, perm].unbind(0))
    return out


def _key_columns(keys: PackedKeys, device) -> list:
    """The sort columns of packed keys on ``device``, in the reference's
    operand order (``uda_tpu/ops/sort.py:240-253``): the prefix words,
    then the overflow rank, then the content length. Rank precedes length:
    two keys that both overflow the carried width with equal prefixes are
    ordered by the bytes past the width (the rank), not by their lengths;
    length then orders the remaining ties. All three columns hold values
    in [0, 2^32), so they travel as one int32 upload."""
    cols = np.empty((keys.num_records, keys.key_words.shape[1] + 2),
                    np.int32)
    cols[:, :-2] = keys.key_words.view(np.int32)
    cols[:, -2] = keys.ranks
    cols[:, -1] = keys.key_lens
    dev = torch.from_numpy(cols).to(resolve_device(device))
    return list(dev.T)


def sort_permutation(keys: PackedKeys, device=None) -> np.ndarray:
    """Stable sort permutation of one run by (key words lexicographic,
    overflow rank, content length), computed on ``device`` (``None`` =
    the card); equal keys keep arrival order. Returns int64 numpy."""
    if keys.num_records == 0:
        return np.zeros(0, np.int64)
    perm = stable_lex_argsort(_key_columns(keys, device))
    return perm.cpu().numpy()


def concat_packed(runs: Sequence[PackedKeys]) -> PackedKeys:
    """Concatenate packed runs (the host-side prelude to merge_runs)."""
    return PackedKeys(
        np.concatenate([r.key_words for r in runs], axis=0),
        np.concatenate([r.key_lens for r in runs]),
        np.concatenate([r.ranks for r in runs]),
    )


def merge_runs(runs: Sequence[PackedKeys],
               device=None) -> tuple[np.ndarray, np.ndarray]:
    """Merge k sorted runs into one global order: ``(perm, run_id)``,
    ``perm`` indexing the concatenation of the runs and ``run_id[i]`` the
    source run of output position i. Each run's overflow ranks are taken
    as they are (see the reference's caveat, ``uda_tpu/ops/sort.py``)."""
    if not runs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cat = concat_packed(runs)
    perm = sort_permutation(cat, device)
    sizes = np.asarray([r.num_records for r in runs], dtype=np.int64)
    bounds = np.cumsum(sizes)
    run_id = np.searchsorted(bounds, perm, side="right")
    return perm, run_id


def sort_records_fixed(keys: PackedKeys, payload, device=None):
    """Device-resident sort of (keys, fixed-stride payload words): the
    rows of ``payload`` (uint32[n, P], numpy or a tensor) in the stable
    key order. Returns ``(sorted_payload, perm)`` as tensors on
    ``device``: uint32[n, P] and the int64 permutation."""
    dev = resolve_device(device)
    perm = stable_lex_argsort(_key_columns(keys, dev))
    if isinstance(payload, np.ndarray):
        payload = torch.from_numpy(
            np.ascontiguousarray(payload, np.uint32).view(np.int32))
    rows = payload.view(torch.int32).to(dev)
    return u32(rows[perm]), perm
