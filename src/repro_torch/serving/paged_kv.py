"""Host-side block bookkeeping for the paged KV cache substrate.

A copy of the JAX package's ``repro/serving/paged_kv.py`` (numpy only).
The device side (``repro_torch.models.transformer.init_paged_cache`` and
the paged decode kernel) only sees a ``(num_blocks, block_size, ...)``
pool and per-slot ``(B, max_blocks)`` int32 block tables.  This module
owns the *policy*: which physical block backs which logical block of
which sequence.

* :class:`BlockAllocator` — refcounted free-list allocator over one
  half-batch's pool.  Block 0 is reserved as the scratch block (dead
  slots' writes land there; it is never granted).  Blocks registered
  under a prefix key are not freed when their refcount drops to zero —
  they move to a *cached* LRU tier, where they stay resurrectable by
  :meth:`lookup` until allocation pressure evicts them.  The cached tier
  counts as available capacity, so admission can never deadlock on
  blocks held only by the prefix cache.
* :func:`prefix_block_keys` — hash-chain keys over the *full* prompt
  blocks (``len(prompt) // block_size``).  Chaining makes a block's key
  depend on everything before it, so two prompts share exactly their
  common block-aligned prefix.

Sharing is copy-free by construction: shared blocks hold only prompt
positions ``< len(prompt)``, and decode writes only positions
``>= len(prompt)`` (speculative rewrites included), so a shared block is
never written after registration.  The refcounts exist to keep a block
alive while any sequence's table points at it — the copy-on-write case
never triggers, and the allocator asserts that invariant instead of
implementing the copy.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def prefix_block_keys(tokens, block_size: int) -> list:
    """Chained digests for each *full* ``block_size`` chunk of a prompt.

    Only full blocks are keyed: a partial final block is private to its
    sequence (decode continues writing into it), so it must never be
    shared.
    """
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    keys, h = [], b""
    for i in range(len(arr) // block_size):
        chunk = arr[i * block_size:(i + 1) * block_size].tobytes()
        h = hashlib.sha256(h + chunk).digest()
        keys.append(h)
    return keys


class BlockAllocator:
    """Refcounted allocator over ``num_blocks`` physical KV blocks.

    Block ids are ints in ``[1, num_blocks)``; block 0 is the reserved
    scratch block.  Capacity accounting: ``used`` blocks hold live
    (refcounted) data, ``cached`` blocks hold resurrectable prefix data
    (ref 0), the rest are free.  ``can_alloc`` counts free + cached,
    since cached blocks are evicted on demand.
    """

    def __init__(self, num_blocks: int, obs=None, name: str = "kv"):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if obs is None:
            from repro_torch.obs import NULL_OBS
            obs = NULL_OBS
        self.obs = obs
        self.name = name                  # label for metrics/trace events
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> low ids
        self._ref: dict[int, int] = {}
        self._cached: OrderedDict[bytes, int] = OrderedDict()  # LRU: old->new
        self._by_key: dict[bytes, int] = {}
        self._key_of: dict[int, bytes] = {}
        self.peak_used = 0
        self.granted_total = 0        # blocks ever granted (incl. reuse)
        self.prefix_hits = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    @property
    def used(self) -> int:
        """Blocks referenced by at least one live sequence."""
        return self.num_blocks - 1 - len(self._free) - len(self._cached)

    @property
    def cached(self) -> int:
        return len(self._cached)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._cached)

    def _note_usage(self):
        self.peak_used = max(self.peak_used, self.used)

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh blocks (ref 1 each), evicting LRU cached
        prefix blocks if the free list runs short."""
        if not self.can_alloc(n):
            raise RuntimeError(f"allocator exhausted: want {n}, have "
                               f"{len(self._free)} free + "
                               f"{len(self._cached)} cached")
        out = []
        for _ in range(n):
            if not self._free:
                key, bid = self._cached.popitem(last=False)   # evict LRU
                del self._by_key[key]
                del self._key_of[bid]
                self.evictions += 1
                if self.obs.enabled:
                    self.obs.metrics.counter(
                        "kv_prefix_evictions_total",
                        "cached prefix blocks evicted under allocation "
                        "pressure").inc(1, alloc=self.name)
                    self.obs.tracer.instant(
                        "kv", "evict", {"alloc": self.name, "block": bid})
                self._free.append(bid)
            bid = self._free.pop()
            self._ref[bid] = 1
            out.append(bid)
        self.granted_total += n
        self._note_usage()
        return out

    def incref(self, bid: int):
        self._ref[bid] += 1

    def decref(self, bid: int):
        """Drop one reference; at zero the block returns to the free list,
        or parks in the cached tier if it carries a prefix key."""
        self._ref[bid] -= 1
        if self._ref[bid] > 0:
            return
        del self._ref[bid]
        key = self._key_of.get(bid)
        if key is not None:
            self._cached[key] = bid       # newest end of the LRU
        else:
            self._free.append(bid)

    # ------------------------------------------------------------------
    # prefix cache
    def lookup(self, key: bytes) -> int | None:
        """Resurrect-or-share the block holding ``key``'s prompt chunk.
        Returns the block id with an acquired reference, or None."""
        bid = self._by_key.get(key)
        if bid is None:
            return None
        if bid in self._ref:              # live: shared with another seq
            self._ref[bid] += 1
        else:                             # parked in the cached tier
            del self._cached[key]
            self._ref[bid] = 1
        self.prefix_hits += 1
        self.granted_total += 1
        if self.obs.enabled:
            self.obs.metrics.counter(
                "kv_prefix_hits_total",
                "admissions served from prefix-cached blocks").inc(
                    1, alloc=self.name)
        self._note_usage()
        return bid

    def export_gauges(self, registry):
        """Publish the allocator's occupancy picture as labeled gauges
        (free / used / cached block counts + peak and grant counters)."""
        g = registry.gauge("kv_blocks",
                           "paged-KV pool blocks by state per allocator")
        g.set(len(self._free), alloc=self.name, state="free")
        g.set(self.used, alloc=self.name, state="used")
        g.set(self.cached, alloc=self.name, state="cached")
        registry.gauge("kv_blocks_peak_used",
                       "high-water mark of live blocks").set(
                           self.peak_used, alloc=self.name)
        registry.gauge("kv_blocks_granted_total",
                       "blocks ever granted (incl. prefix reuse)").set(
                           self.granted_total, alloc=self.name)

    def register(self, bid: int, key: bytes):
        """Publish a freshly written full-prompt block under its chain
        key.  First writer wins; the block must be live (shared blocks
        are immutable, so re-registering an existing key is a no-op)."""
        assert bid in self._ref, "registering a block with no references"
        if key in self._by_key or bid in self._key_of:
            return
        self._by_key[key] = bid
        self._key_of[bid] = key

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks, "used": self.used,
                "cached": self.cached, "free": len(self._free),
                "peak_used": self.peak_used,
                "granted_total": self.granted_total,
                "prefix_hits": self.prefix_hits,
                "evictions": self.evictions}
