"""Deterministic consistent-hash ring for warn-shard routing.

The port's copy of ``kakveda_tpu/fleet/hashring.py``, line for line: an
assignment is a pure function of the key and the membership, so the two
packages place every key alike.

Why a ring and not ``hash(key) % N``: replica loss must remap only the
keys the dead replica owned (~1/N of traffic), never reshuffle the whole
key space — the warn path's per-replica match caches and incremental
mining reuse (``index/gfkb.py`` match cache) are keyed by signature, and
a global reshuffle would cold-start every one of them at once.

Why :func:`hashlib.blake2b` and not Python's ``hash()``: ``hash()`` is
salted per process (PYTHONHASHSEED), so a restarted router would assign
every key differently — assignment must be a pure function of
(key, membership) so routers can restart, and replicas can be probed
back in, without a remap storm.  Tested properties
(tests/test_fleet.py, tests/test_torch_fleet.py): identical assignment
across independent ring instances, and remap fraction on single-node
loss ≲ 1/N + slack.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from typing import Iterable, List, Optional, Sequence, Tuple


def _point(key: str) -> int:
    """64-bit ring position — stable across processes and Python builds."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``vnodes`` spreads each node over the ring so load stays balanced even
    at small N (64 vnodes keeps the max/mean shard ratio ≲ 1.3 at N=4).
    """

    def __init__(self, nodes: Iterable[str], vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        # Insertion order preserved, duplicates dropped (node ids are the
        # routing identity — two vnode sets for one id would double-weight it).
        self._nodes: List[str] = list(dict.fromkeys(nodes))
        ring: List[Tuple[int, str]] = []
        for n in self._nodes:
            for v in range(self.vnodes):
                ring.append((_point(f"{n}#{v}"), n))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]

    @property
    def nodes(self) -> List[str]:
        return list(self._nodes)

    def preference(self, key: str, limit: Optional[int] = None) -> List[str]:
        """Distinct nodes in clockwise ring order from ``key``'s position —
        element 0 is the owner, the rest are the stable failover order
        (retry-on-next-replica walks this list)."""
        if not self._ring:
            return []
        limit = len(self._nodes) if limit is None else min(limit, len(self._nodes))
        out: List[str] = []
        start = bisect_right(self._points, _point(key))
        for i in range(len(self._ring)):
            node = self._ring[(start + i) % len(self._ring)][1]
            if node not in out:
                out.append(node)
                if len(out) >= limit:
                    break
        return out

    def arc_preferences(self, limit: Optional[int] = None) -> List[Tuple[str, ...]]:
        """Per-vnode-arc holder walks: for every arc of the ring (keys
        hashing into it start their clockwise walk at that arc's vnode),
        the distinct-node preference tuple of length ≤ ``limit``.

        This enumerates every assignment outcome the ring can produce —
        sharded ownership (fleet/ownership.py) uses it to count a
        replica's owned/standby ranges and to detect coverage holes
        exactly, instead of sampling keys."""
        if not self._ring:
            return []
        limit = len(self._nodes) if limit is None else min(limit, len(self._nodes))
        n = len(self._ring)
        out: List[Tuple[str, ...]] = []
        for start in range(n):
            pref: List[str] = []
            for i in range(n):
                node = self._ring[(start + i) % n][1]
                if node not in pref:
                    pref.append(node)
                    if len(pref) >= limit:
                        break
            out.append(tuple(pref))
        return out

    def assign(self, key: str, exclude: Sequence[str] = ()) -> Optional[str]:
        """The owning node for ``key``, skipping ``exclude`` (ejected
        replicas). Membership does NOT change on ejection — the ring stays
        stable and excluded keys spill to their failover successor, so a
        probe-recovered replica gets its exact old keys back."""
        for node in self.preference(key):
            if node not in exclude:
                return node
        return None
