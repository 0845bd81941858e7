"""Failpoint injection framework: named fault sites on the data plane.

The port's copy of ``uda_tpu/utils/failpoints.py``. Production code
declares named injection sites::

    data = failpoint("data_engine.pread", data=data, key=req.map_id)

which are no-ops until armed, from the ``UDA_FAILPOINTS`` environment
variable, the ``uda.tpu.failpoints`` config key, or a test's
``failpoints.scoped(...)`` context, to raise a typed ``UdaError``, delay
by N ms, truncate a chunk, or corrupt bytes.

Spec grammar (comma- or semicolon-separated entries)::

    <site>=<action>[:<arg>][:<trigger>[:<value>]]...

    actions   error[:storage|transport|merge|protocol|config|uda|
                     compression|tenant]
              delay:<ms>
              truncate[:<bytes>]         (drops the chunk tail; >= 1 byte kept)
              corrupt[:<bytes>]          (flips bytes at seeded positions)
    triggers  every:<n>                  (every Nth eligible call)
              once                       (first eligible call only)
              prob:<p>                   (seeded RNG, see seed:)
              seed:<s>                   (RNG seed for prob/corrupt)
              match:<substr>             (only calls whose key contains substr)
              (no trigger = every eligible call)

Triggers are deterministic: ``every`` and ``once`` count calls under a
lock, ``prob`` and ``corrupt`` draw from a per-site seeded RNG, so a
schedule fires on the same calls, and mangles the same bytes, as the
reference's.

Sites of the port: ``data_engine.pread`` (the supplier's chunk read; it
carries data, so truncate/corrupt apply), ``segment.fetch`` (the
``InputClient.start_fetch`` boundary), ``coding.decode`` (a stripe
reconstruction's decode), ``ckpt.save`` (the assembled manifest bytes) and
``ckpt.load`` (the manifest walk), ``data_engine.preadv`` (a batched
read's bytes), ``decompress.block`` (one decoded compressed block),
``net.accept``, ``net.connect``, ``net.frame`` (each outbound frame's
head, on both sides), ``net.handoff`` (the warm-restart record's load
and save), ``net.push`` (each MSG_PUSH frame, on the supplier) and
``push.admit`` (each pushed chunk's admission on the reduce side),
``tenant.register`` and ``tenant.validate`` (the tenant registry's
MSG_JOB and per-request gates), and ``store.get``, ``store.put`` and
``store.migrate`` (the disaggregated store, keyed ``<backend>:<key>``).
The other sites the reference knows (``exchange.*``, ``bridge.upcall``)
live in modules the port lacks: arming one raises
:class:`ConfigError` naming the site and that module, never a schedule
that could not fire. A name the reference does not know either arms as
it does there (tests use such names).

Left out: the flight recorder's record of each fire, the resource
ledger's accounting of scopes, and ``chaos_spec``/``net_chaos_spec``,
which wait for their callers.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
import zlib
from collections import defaultdict
from typing import Dict, Iterator, Optional

from uda_tpu_torch.utils.errors import (CompressionError, ConfigError,
                                        MergeError, ProtocolError,
                                        StorageError, StoreError,
                                        TenantError, TransportError,
                                        UdaError)
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["Failpoint", "FailpointRegistry", "failpoints", "failpoint",
           "KNOWN_SITES", "PORTED_SITES"]

_ACTIONS = ("error", "delay", "truncate", "corrupt")

_ERROR_KINDS = {
    "storage": StorageError,
    "transport": TransportError,
    "merge": MergeError,
    "protocol": ProtocolError,
    "config": ConfigError,
    "uda": UdaError,
    "compression": CompressionError,
    "tenant": TenantError,
}

# default injected-error class per site: what the real fault at that layer
# raises, so recovery paths see realistic types
_SITE_ERRORS = {
    "data_engine.pread": StorageError,
    "segment.fetch": TransportError,
    "exchange.round": TransportError,
    "bridge.upcall": UdaError,
    "net.frame": TransportError,
    "net.accept": TransportError,
    "net.connect": TransportError,
    "coding.decode": StorageError,
    "net.handoff": StorageError,
    "exchange.decode": StorageError,
    "decompress.block": CompressionError,
    "data_engine.preadv": StorageError,
    "tenant.register": TenantError,
    "tenant.validate": TenantError,
    "ckpt.save": StorageError,
    "ckpt.load": StorageError,
    "store.get": StoreError,
    "store.put": StoreError,
    "store.migrate": StoreError,
    "net.push": TransportError,
    "push.admit": StorageError,
}

KNOWN_SITES = tuple(_SITE_ERRORS)

# the reference module behind every known site the port lacks
_UNPORTED_SITE_MODULES = {
    "exchange.round": "uda_tpu/parallel/exchange.py",
    "exchange.decode": "uda_tpu/parallel/exchange.py",
    "bridge.upcall": "uda_tpu/bridge/bridge.py",
}

# the sites whose code the port has
PORTED_SITES = tuple(s for s in KNOWN_SITES
                     if s not in _UNPORTED_SITE_MODULES)


class Failpoint:
    """One armed site: parsed spec + trigger state (calls/fired counters
    and the per-site seeded RNG for prob/corrupt determinism)."""

    def __init__(self, site: str, spec: str):
        self.site = site
        self.spec = spec
        self.action = ""
        self.error_kind: Optional[str] = None
        self.delay_ms = 0.0
        self.nbytes: Optional[int] = None
        self.trigger = "always"
        self.every = 0
        self.prob = 0.0
        self.seed: Optional[int] = None
        self.match = ""
        self.calls = 0
        self.fired = 0
        self._parse(spec)
        self.rng = random.Random(self.seed if self.seed is not None
                                 else zlib.crc32(site.encode()))

    def _parse(self, spec: str) -> None:
        toks = [t for t in spec.split(":") if t != ""]
        if not toks or toks[0] not in _ACTIONS:
            raise ConfigError(
                f"failpoint {self.site}: bad action in {spec!r} "
                f"(want one of {_ACTIONS})")
        self.action = toks[0]
        i = 1
        # positional action argument, when present
        if self.action == "error" and i < len(toks) \
                and toks[i] in _ERROR_KINDS:
            self.error_kind = toks[i]
            i += 1
        elif self.action == "delay":
            if i >= len(toks):
                raise ConfigError(
                    f"failpoint {self.site}: delay needs <ms> in {spec!r}")
            self.delay_ms = float(toks[i])
            i += 1
        elif self.action in ("truncate", "corrupt") and i < len(toks) \
                and toks[i].isdigit():
            self.nbytes = int(toks[i])
            i += 1
        while i < len(toks):
            tok = toks[i]
            if tok == "once":
                self.trigger = "once"
                i += 1
            elif tok in ("every", "prob", "seed", "match"):
                if i + 1 >= len(toks):
                    raise ConfigError(
                        f"failpoint {self.site}: {tok} needs a value "
                        f"in {spec!r}")
                val = toks[i + 1]
                if tok == "every":
                    self.trigger = "every"
                    self.every = max(1, int(val))
                elif tok == "prob":
                    self.trigger = "prob"
                    self.prob = float(val)
                elif tok == "seed":
                    self.seed = int(val)
                else:
                    self.match = val
                i += 2
            else:
                raise ConfigError(
                    f"failpoint {self.site}: unknown token {tok!r} "
                    f"in {spec!r}")

    def should_fire(self) -> bool:
        """Trigger decision for one eligible call; the caller holds the
        registry lock."""
        self.calls += 1
        if self.trigger == "every":
            return self.calls % self.every == 0
        if self.trigger == "once":
            return self.fired == 0
        if self.trigger == "prob":
            return self.rng.random() < self.prob
        return True

    def make_error(self) -> UdaError:
        cls = (_ERROR_KINDS[self.error_kind] if self.error_kind
               else _SITE_ERRORS.get(self.site, UdaError))
        err = cls(f"failpoint {self.site}: injected "
                  f"{self.error_kind or cls.__name__} fault "
                  f"(hit {self.fired})")
        err.failpoint_site = self.site
        return err


class FailpointRegistry:
    """Process-global site table. Disarmed evaluation is one dict probe;
    armed sites count hits (``hits[site]``) and a ``failpoint.<site>``
    counter per injection."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: Dict[str, Failpoint] = {}
        self.hits: Dict[str, int] = defaultdict(int)

    def arm(self, site: str, spec: str) -> None:
        """Arm one site. Re-arming with the identical spec keeps its
        trigger state (every component built from one config re-arms it);
        ``disarm`` first to restart a schedule. A known site whose module
        the port lacks is refused."""
        module = _UNPORTED_SITE_MODULES.get(site)
        if module is not None:
            raise ConfigError(
                f"uda.tpu.failpoints: site {site!r} lives in {module}, "
                f"which is not ported to uda_tpu_torch yet")
        fp = Failpoint(site, spec)  # parse (and fail) before arming
        with self._lock:
            cur = self._sites.get(site)
            if cur is not None and cur.spec == spec:
                return
            self._sites[site] = fp

    def arm_spec(self, spec: str) -> None:
        """Arm from a full ``site=spec[,site=spec...]`` string (the
        UDA_FAILPOINTS / uda.tpu.failpoints syntax)."""
        for entry in spec.replace(";", ",").split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ConfigError(f"bad failpoint entry {entry!r} "
                                  f"(want site=action[:...])")
            site, _, body = entry.partition("=")
            self.arm(site.strip(), body.strip())

    def disarm(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def active(self) -> Dict[str, str]:
        """site -> spec of every armed failpoint."""
        with self._lock:
            return {s: fp.spec for s, fp in self._sites.items()}

    def is_armed(self, site: str) -> bool:
        return site in self._sites

    @contextlib.contextmanager
    def scoped(self, spec: str) -> Iterator["FailpointRegistry"]:
        """Arm ``spec`` for the duration of a with-block, restoring the
        previous arming (trigger state included) on exit."""
        with self._lock:
            saved = dict(self._sites)
        try:
            self.arm_spec(spec)
            yield self
        finally:
            with self._lock:
                self._sites = saved

    def evaluate(self, site: str, data: Optional[bytes],
                 key: str) -> Optional[bytes]:
        with self._lock:
            fp = self._sites.get(site)
            if fp is None:
                return data
            if fp.match and fp.match not in key:
                return data
            if not fp.should_fire():
                return data
            fp.fired += 1
            self.hits[site] += 1
            # corrupt positions come from the seeded RNG under the lock
            # that serializes the trigger decision
            if fp.action == "corrupt" and data:
                n = min(fp.nbytes or 1, len(data))
                positions = [fp.rng.randrange(len(data)) for _ in range(n)]
            else:
                positions = []
        metrics.add(f"failpoint.{site}")
        if fp.action == "delay":
            time.sleep(fp.delay_ms / 1000.0)
            return data
        if fp.action == "error":
            raise fp.make_error()
        if data is None:
            return data  # truncate/corrupt need a data-bearing site
        if fp.action == "truncate":
            drop = fp.nbytes if fp.nbytes is not None else len(data) // 2
            return data[:max(1, len(data) - drop)]
        out = bytearray(data)
        for p in positions:
            out[p] ^= 0xFF
        return bytes(out)


failpoints = FailpointRegistry()


def failpoint(site: str, data: Optional[bytes] = None,
              key: str = "") -> Optional[bytes]:
    """Evaluate one injection site. Returns ``data`` (possibly truncated
    or corrupted); may sleep or raise a typed ``UdaError`` whose message
    names the site. One dict-emptiness check when nothing is armed."""
    if not failpoints._sites:
        return data
    return failpoints.evaluate(site, data, key)


def _load_env(env=None) -> None:
    spec = (env if env is not None else os.environ).get("UDA_FAILPOINTS")
    if spec:
        failpoints.arm_spec(spec)


_load_env()
