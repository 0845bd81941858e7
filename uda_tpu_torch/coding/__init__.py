"""k-of-n erasure-coded map outputs (the survivable-shuffle layer).

The port's copy of ``uda_tpu/coding/__init__.py``. With
``uda.tpu.coding.scheme=rs:k:n`` each map partition's on-disk bytes are a
systematic Reed-Solomon stripe — k data chunks + (n-k) parity chunks over
GF(2^8) (``coding/rs``, host numpy) — spread over n suppliers, and the
reduce side can rebuild the partition from any k of them when the primary
is dead or penalized (``coding/recovery``, the post-retry rung of the
Segment ladder). The reference's ``coding/gfjax.py`` (the same field on
the device, for the coded exchange of ``parallel/``) is not ported.

Layout contract (shared with ``mofserver``):

- the PRIMARY supplier holds the full plain MOF with the parity chunks
  appended as a parity section (data offsets byte-identical to the
  uncoded layout) and a v2 index recording the stripe (index.py);
- stripe chunk ``i`` is addressable as the shard pseudo-map
  ``<map_id>~s<i>`` — a tiny MOF of its own on peer suppliers, or a
  synthesized byte range of the primary's file.out (both resolve
  through the ordinary DirIndexResolver, so the whole data plane —
  DataEngine, wire, zero-copy serve — serves shards unchanged);
- placement is derived over the job's canonically-ordered supplier
  list (sorted unique host strings) by :func:`stripe_host`: the
  positional rotation ``(p + i) % num_suppliers`` by default, or —
  with ``uda.tpu.coding.domains`` declared — a FAILURE-DOMAIN-aware
  interleave (:func:`stripe_order`) that walks the domains round-robin
  so one rack/power domain never accumulates enough of a stripe's
  shards to make it unrecoverable. Writer and reducer derive it
  independently from the same rule and the same domain map — no
  placement metadata travels. Chunk 0 always stays on the primary
  (its chunks are synthesized from file.out, never duplicated).

The decoder slots in BELOW DecompressingClient and the CRC layer:
reconstruction rebuilds the partition's on-disk bytes, so compression
and integrity checking downstream stay byte-agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from uda_tpu_torch.mofserver.index import parse_shard_id, shard_map_id
from uda_tpu_torch.utils.errors import ConfigError
from uda_tpu_torch.utils.logging import get_logger

__all__ = ["CodingScheme", "parse_scheme", "parse_domains",
           "domain_labels", "stripe_order", "stripe_host",
           "shard_map_id", "parse_shard_id"]

log = get_logger()


@dataclasses.dataclass(frozen=True)
class CodingScheme:
    """One parsed ``uda.tpu.coding.scheme`` value (``rs:k:n``)."""

    k: int
    n: int

    @property
    def parity(self) -> int:
        return self.n - self.k

    def __str__(self) -> str:
        return f"rs:{self.k}:{self.n}"


def parse_scheme(spec: str) -> Optional[CodingScheme]:
    """``"rs:k:n"`` -> CodingScheme; empty/None -> None (coding off)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) != 3 or parts[0] != "rs":
        raise ConfigError(f"bad uda.tpu.coding.scheme {spec!r} "
                          f"(want rs:<k>:<n>)")
    try:
        k, n = int(parts[1]), int(parts[2])
    except ValueError as e:
        raise ConfigError(f"bad uda.tpu.coding.scheme {spec!r}: {e}") from e
    if not (1 <= k <= n <= 255):
        raise ConfigError(f"bad uda.tpu.coding.scheme {spec!r} "
                          f"(need 1 <= k <= n <= 255)")
    return CodingScheme(k, n)


def parse_domains(spec: str) -> dict:
    """``uda.tpu.coding.domains`` -> {supplier: domain}. The spec is
    ``'host=domain,host=domain,...'``; empty/None -> {} (positional
    rotation). A segment without '=' is a ConfigError — a silently
    dropped declaration would quietly degrade the placement back to
    rotation on exactly the host someone meant to protect."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, dom = part.partition("=")
        if not sep or not host.strip() or not dom.strip():
            raise ConfigError(f"bad uda.tpu.coding.domains segment "
                              f"{part!r} (want host=domain)")
        out[host.strip()] = dom.strip()
    return out


def stripe_order(count: int, primary_index: int,
                 domains: Optional[Sequence[str]] = None) -> list:
    """The placement permutation of supplier INDICES for one stripe:
    position i of the result holds chunk i. Without ``domains`` it is
    the positional rotation ``(primary + i) % count``. With ``domains`` (one label per supplier index;
    undeclared suppliers should be pre-mapped to singleton domains by
    the caller) the order interleaves ROUND-ROBIN across domains —
    primary's domain first, then the others by first appearance —
    taking each domain's suppliers in rotation order, so consecutive
    chunks land in distinct domains while any remain: a stripe's n
    shards spread ``ceil``-evenly and no domain accumulates more than
    ``ceil(n / num_domains)`` of them. Position 0 is ALWAYS the
    primary (chunk 0 is synthesized from its file.out)."""
    if count <= 0:
        return []
    primary_index %= count
    rotation = [(primary_index + i) % count for i in range(count)]
    if not domains:
        return rotation
    if len(domains) != count:
        raise ConfigError(f"stripe_order: {len(domains)} domain labels "
                          f"for {count} suppliers")
    # group the rotation by domain, preserving rotation order inside
    # each; ring the domains by first appearance along the rotation
    # (primary's domain is first by construction)
    ring: list = []
    by_dom: dict = {}
    for idx in rotation:
        dom = domains[idx]
        if dom not in by_dom:
            by_dom[dom] = []
            ring.append(dom)
        by_dom[dom].append(idx)
    order = []
    cursors = {dom: 0 for dom in ring}
    while len(order) < count:
        for dom in ring:
            cur = cursors[dom]
            if cur < len(by_dom[dom]):
                order.append(by_dom[dom][cur])
                cursors[dom] = cur + 1
    return order[:count]


_WARNED_NAMESPACES: set = set()


def domain_labels(suppliers: Sequence[str],
                  domains: Optional[dict]) -> Optional[list]:
    """Per-supplier domain labels for :func:`stripe_order`, or None
    when no domains are declared. The writer keys ``uda.tpu.coding.
    domains`` by supplier ROOTS and the reduce side by HOST names —
    ONE spec must therefore declare BOTH namespaces (extra keys are
    harmless; each side matches its own). A declared map that matches
    NONE of this side's suppliers silently degrades every supplier to
    a singleton domain — which is exactly the positional rotation, so
    writer and reducer still AGREE when both sides miss, but a
    one-sided miss would place shards where the other side never
    looks: warn LOUDLY (once per supplier set) so the misdeclared
    namespace is caught before the k-th loss needs the placement."""
    if not domains:
        return None
    if not any(s in domains for s in suppliers):
        # warn once per (supplier set, SPEC) — a re-edited spec that
        # is still mismatched must warn again; bounded so a long-lived
        # daemon's many jobs cannot grow the set without limit
        key = (tuple(sorted(suppliers)),
               tuple(sorted(domains.items())))
        if key not in _WARNED_NAMESPACES:
            if len(_WARNED_NAMESPACES) >= 256:
                _WARNED_NAMESPACES.clear()
            _WARNED_NAMESPACES.add(key)
            log.warn(
                f"uda.tpu.coding.domains declares {len(domains)} "
                f"entr(ies) but matches NONE of this side's suppliers "
                f"{list(suppliers)[:4]}... — placement degrades to "
                f"the positional rotation HERE; if the other side's "
                f"namespace matches, writer and reducer DISAGREE. "
                f"Declare both namespaces (hosts and writer roots) in "
                f"the one spec.")
    return [domains.get(s, s) for s in suppliers]


def stripe_host(suppliers: Sequence[str], primary: str, chunk: int,
                domains: Optional[dict] = None) -> str:
    """The supplier holding stripe chunk ``chunk`` of a map whose
    primary is ``primary``: the :func:`stripe_order` permutation
    (positional rotation, or failure-domain interleave when
    ``domains`` — a {supplier: domain} map — is declared; suppliers
    absent from the map count as their own singleton domain). A
    primary absent from the list (a supplier the reduce side never
    saw as a map host) anchors at index 0 — placement stays total
    either way."""
    if not suppliers:
        return primary
    suppliers = list(suppliers)
    try:
        p = suppliers.index(primary)
    except ValueError:
        p = 0
    order = stripe_order(len(suppliers), p,
                         domain_labels(suppliers, domains))
    return suppliers[order[chunk % len(suppliers)]]
