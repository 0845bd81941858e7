"""Online tuning cache: persisted per-(key-shape, platform, backend)
fly-off winners that make routing self-service.

The port's copy of ``uda_tpu/utils/tuncache.py``, with the same JSON
schema (``SCHEMA_VERSION``), so a cache file written by either package
routes the other. A small persisted winner table is

- **written** by fly-off probes (any in-process probe can call
  :meth:`TuneCache.record`),
- **consulted** by ``ops.sort.route_engine`` (engine choice per
  (backend, row-bucket, lanes-capability)) and by the batched host-I/O
  plane of ``mofserver/data_engine.py``,
- **refreshed** by a background re-probe rung: entries older than a
  horizon are re-measured by a registered probe on a daemon thread
  (:func:`ensure_fresh`).

Precedence is strict: **explicit env/config winner > cached winner >
built-in default**. A cold cache routes exactly as the built-in defaults;
a corrupt, truncated or version-bumped cache file is ignored (counted
``tune.cache.invalid``), never fatal.

File format (JSON, atomic tmp+rename writes)::

    {"schema": 1, "entries": {
        "<domain>|<key>": {"winner": {...}, "metric": <float|null>,
                           "probed_unix": <float>, "probe": "<name>"}}}

``domain`` names the consumer contract (``sort.engine``); ``key`` encodes
the shape/platform/backend coordinates the consumer can cheaply reproduce
at lookup time (e.g. ``gpu|rows27|lanes1``). ``winner`` is an opaque dict
the consumer validates: a cache can never force an invalid engine name
onto a caller (validation failures count as misses).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional

from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["TuneCache", "tune_cache", "set_default_cache",
           "cache_path_from_env", "register_probe", "ensure_fresh",
           "rows_bucket", "SCHEMA_VERSION"]

log = get_logger()

SCHEMA_VERSION = 1


def cache_path_from_env() -> str:
    """The process-default cache location: UDA_TPU_TUNE_CACHE (the
    ``uda.tpu.tune.cache.path`` config key wins where a Config is in
    hand: consumers pass the resolved path in). Empty = no cache."""
    return os.environ.get("UDA_TPU_TUNE_CACHE", "").strip()


def rows_bucket(n_rows: int) -> int:
    """Shape-class key for row counts: the power-of-two bucket
    (bit_length), so one probed winner covers its whole size class
    instead of one exact row count."""
    return max(0, int(n_rows)).bit_length()


class TuneCache:
    """One winner table bound to one file path (``path=''`` = a purely
    in-memory table: lookups miss until something records).

    Reads are cached per (path, mtime): route_engine sits on production
    sort surfaces, so a lookup is a dict access, not a file parse —
    the file is re-read only when another process replaced it."""

    def __init__(self, path: str = ""):
        self.path = path or ""
        self._mu = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._loaded_mtime: Optional[float] = None
        self._invalid_warned = False

    # -- persistence ---------------------------------------------------------

    def _load_locked(self) -> None:
        """Refresh the in-memory table from the file when it changed.
        Every failure mode — missing file, torn JSON, wrong schema,
        non-dict entries — degrades to an empty table (built-in
        defaults), counted once per observation, never raised."""
        if not self.path:
            return
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            self._entries = {}
            self._loaded_mtime = None
            return
        if mtime == self._loaded_mtime:
            return
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) \
                    or doc.get("schema") != SCHEMA_VERSION \
                    or not isinstance(doc.get("entries"), dict):
                raise ValueError(
                    f"schema {doc.get('schema') if isinstance(doc, dict) else '?'}"
                    f" != {SCHEMA_VERSION} or malformed shape")
            entries = {k: v for k, v in doc["entries"].items()
                       if isinstance(v, dict) and "winner" in v}
        except (OSError, ValueError) as e:
            metrics.add("tune.cache.invalid")
            if not self._invalid_warned:
                self._invalid_warned = True
                log.warn(f"tune cache {self.path} ignored ({e}); "
                         f"using built-in defaults")
            self._entries = {}
            self._loaded_mtime = mtime  # don't re-parse a bad file per lookup
            return
        self._entries = entries
        self._loaded_mtime = mtime

    def _save_locked(self) -> None:
        if not self.path:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"schema": SCHEMA_VERSION,
                           "entries": self._entries}, f, indent=1,
                          sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
            try:
                self._loaded_mtime = os.stat(self.path).st_mtime
            except OSError:
                self._loaded_mtime = None
            metrics.add("tune.cache.writes")
        except OSError as e:
            # a read-only dir / full disk must not fail the probe (or
            # the job that ran it): the winner just isn't persisted
            metrics.add("errors.swallowed")
            log.warn(f"tune cache {self.path} not persisted ({e})")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- the consumer surface ------------------------------------------------

    def lookup(self, domain: str, key: str) -> Optional[dict]:
        """The persisted winner record for ``domain|key``, or None
        (cold cache / unreadable file / no such entry). Counts
        ``tune.cache.hits``/``tune.cache.misses`` labeled by domain —
        the lifecycle tests key on these."""
        with self._mu:
            self._load_locked()
            rec = self._entries.get(f"{domain}|{key}")
        if rec is None:
            metrics.add("tune.cache.misses", domain=domain)
            return None
        metrics.add("tune.cache.hits", domain=domain)
        return dict(rec)

    def record(self, domain: str, key: str, winner: dict,
               metric: Optional[float] = None,
               probe: str = "") -> None:
        """Persist one fly-off winner (atomic write; merges with the
        entries already on disk so concurrent probes of different
        domains don't clobber each other)."""
        rec = {"winner": dict(winner), "metric": metric,
               "probed_unix": time.time(), "probe": probe}
        with self._mu:
            self._load_locked()
            self._entries[f"{domain}|{key}"] = rec
            self._save_locked()

    def age_s(self, domain: str, key: str) -> Optional[float]:
        """Seconds since the entry was probed; None when absent (or
        the record carries no timestamp — treated as infinitely
        stale by re-probe consumers)."""
        with self._mu:
            self._load_locked()
            rec = self._entries.get(f"{domain}|{key}")
        if rec is None:
            return None
        probed = rec.get("probed_unix")
        if not isinstance(probed, (int, float)):
            return float("inf")
        return max(0.0, time.time() - float(probed))

    def entries(self) -> Dict[str, dict]:
        """Snapshot of the table (diagnostics)."""
        with self._mu:
            self._load_locked()
            return {k: dict(v) for k, v in self._entries.items()}


# The process-default cache (UDA_TPU_TUNE_CACHE): what config-less
# consumers (ops.sort.route_engine) consult. Consumers holding a
# Config with uda.tpu.tune.cache.path set read their own instance AND
# install the path as the process default via set_default_cache, so
# one explicitly-configured engine makes the whole process
# self-service — the env var always wins.
tune_cache = TuneCache(cache_path_from_env())


def set_default_cache(path: str) -> TuneCache:
    """Install ``path`` as the process-default cache, unless
    UDA_TPU_TUNE_CACHE is set (the env channel outranks config, like every
    deploy override), so route_engine (which has no Config in scope)
    consults the same table as a consumer that holds an explicit
    ``uda.tpu.tune.cache.path``. Returns the instance now serving the
    path (consumers that read the module attribute at call time pick it
    up immediately)."""
    global tune_cache
    if not path or cache_path_from_env():
        return tune_cache
    if path != tune_cache.path:
        tune_cache = TuneCache(path)
    return tune_cache


# -- background re-probe rung -------------------------------------------------
# A consumer that wants its winner tracked against hardware drift
# registers a probe callable; ensure_fresh() then re-measures a stale
# entry on a single daemon thread (at most one re-probe in flight per
# process — routing hot paths must never block on a fly-off).

_PROBES: Dict[str, Callable[[str], None]] = {}
_REPROBE_MU = threading.Lock()
_REPROBE_ACTIVE = False


def register_probe(domain: str, fn: Callable[[str], None]) -> None:
    """Register the re-probe implementation for ``domain``: called as
    ``fn(key)`` on the background thread; it should measure and
    ``record()`` the fresh winner."""
    _PROBES[domain] = fn


def ensure_fresh(cache: TuneCache, domain: str, key: str,
                 max_age_s: float) -> None:
    """Kick a background re-probe when the entry exists but is older
    than ``max_age_s`` (0/negative = never re-probe). Non-blocking;
    the current lookup keeps the stale winner; the refreshed one lands
    for later consumers."""
    global _REPROBE_ACTIVE
    if max_age_s <= 0:
        return
    fn = _PROBES.get(domain)
    if fn is None:
        return
    age = cache.age_s(domain, key)
    if age is None or age <= max_age_s:
        return
    with _REPROBE_MU:
        if _REPROBE_ACTIVE:
            return
        _REPROBE_ACTIVE = True

    def _run() -> None:
        global _REPROBE_ACTIVE
        try:
            metrics.add("tune.reprobes")
            fn(key)
        except Exception as e:  # noqa: BLE001 - a failed re-probe must
            # never surface into the routing caller; the stale winner
            # keeps serving
            metrics.add("errors.swallowed")
            log.warn(f"tune re-probe of {domain}|{key} failed: {e}")
        finally:
            with _REPROBE_MU:
                _REPROBE_ACTIVE = False

    threading.Thread(target=_run, daemon=True,
                     name="uda-tune-reprobe").start()
