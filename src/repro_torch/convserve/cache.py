"""Pre-transformed kernel cache (the paper's footnote-1 inference path).

Transformed convolutions never touch raw HWIO kernels at serving time:
the right-hand matrices are computed once by the owning algorithm's
`prepare_weights` and reused by every request.  The cache is fully
algorithm-agnostic -- it asks the registry which algorithms consume
pre-transformed kernels and which params shape the transform
(`Algorithm.prepare_key`), so a newly registered algorithm is cached
correctly with zero changes here.  Entries are memoized per
(net, layer, algo, geometry, weight-params, dtype, weight-fingerprint)
so that

  * repeated requests -- and different shape buckets of the same net --
    hit the cache (the key excludes the activation spatial dims), and
  * two layers that happen to share a geometry but hold different weights
    never collide (the layer index and weight hash are part of the key).

The store is optionally bounded: with `capacity_bytes` set, entries
evict least-recently-used once the resident transforms exceed the
budget (many nets/buckets sharing one engine no longer grow without
bound; an evicted layer simply re-transforms on next use and counts a
miss).  Hit/miss/eviction/invalidation counters make reuse and
weight-update churn observable; `stats()` feeds benchmarks, the serving
front-ends, and the runtime's telemetry.  All mutation happens under an
internal lock so replica pools can share one cache across threads.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.convserve.plan import LayerPlan
from repro_torch.core.device import dtype_name, publish


def weights_fingerprint(w) -> str:
    """Content hash of a kernel tensor: ties cache entries to the actual
    parameter values, so two executors sharing a cache but holding
    different weights for the same net never serve each other's
    transforms, while identical weights still share entries.  A bf16
    tensor (numpy has no bf16) is hashed as its 16-bit patterns."""
    t = torch.as_tensor(w).detach().cpu().contiguous()
    arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return hashlib.sha1(
        arr.tobytes() + str(arr.shape).encode() + dtype_name(t.dtype).encode()
    ).hexdigest()[:16]


class KernelCache:
    """Memoized right-hand (transformed-kernel) matrices, optionally
    LRU-bounded to `capacity_bytes` of resident transforms."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
        self._store: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()
        self._nbytes = 0  # guarded-by: _lock
        self.capacity_bytes = capacity_bytes
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock

    @staticmethod
    def key(net: str, plan: LayerPlan, dtype, w_fp: str) -> Tuple:
        alg = registry.get(plan.algo)
        s = plan.spec
        return (
            net, plan.layer, plan.algo,
            s.k, s.c_in, s.c_out, s.groups,
            alg.prepare_key(plan.params),
            dtype_name(dtype), w_fp,
        )

    def get(
        self,
        net: str,
        plan: LayerPlan,
        w: torch.Tensor,
        dtype=torch.float32,
        w_fp: Optional[str] = None,
    ) -> Optional[torch.Tensor]:
        """Transformed kernels for this layer, building on first use.

        `w_fp` is the weight fingerprint; pass a precomputed one (the
        executor hashes each layer once at init) to avoid re-hashing per
        request.  The transform is computed on `w`'s device.  Returns
        None for algorithms with no consumable pre-transform (direct
        conv); those are not counted as hits or misses.
        """
        alg = registry.get(plan.algo)
        if not alg.consumes_wt:
            return None
        key = self.key(net, plan, dtype, w_fp or weights_fingerprint(w))
        with self._lock:
            cached = self._store.get(key)
            if cached is not None:
                self.hits += 1
                self._store.move_to_end(key)  # most-recently-used
                return cached
            self.misses += 1
        # transform outside the lock: kernel prep is the expensive part,
        # and a racing replica at worst duplicates work, never corrupts
        wt = alg.prepare_weights(w.to(dtype), plan.algo_plan())
        # replicas run on streams of their own: the entry is published only
        # once the stream that prepared it has finished writing it
        publish(wt)
        with self._lock:
            if key not in self._store:
                self._store[key] = wt
                self._nbytes += wt.nbytes
                self._evict_over_capacity(keep=key)
        return wt

    def _evict_over_capacity(self, keep: Tuple) -> None:
        # holds-lock: _lock (callers evict inside their locked section)
        """Drop LRU entries until under budget.  The entry being served
        right now (`keep`) is never evicted -- a single transform larger
        than the whole budget still serves, it just lives alone."""
        if self.capacity_bytes is None:
            return
        while self._nbytes > self.capacity_bytes and len(self._store) > 1:
            key = next(iter(self._store))
            if key == keep:
                self._store.move_to_end(key)
                key = next(iter(self._store))
            wt = self._store.pop(key)
            self._nbytes -= wt.nbytes
            self.evictions += 1

    def invalidate(self, net: Optional[str] = None) -> None:
        """Drop entries (all, or one net's) -- call after a weight
        update.  Each call counts once in `invalidations`, so weight
        churn is visible in serving stats."""
        with self._lock:
            self.invalidations += 1
            if net is None:
                self._store.clear()
                self._nbytes = 0
            else:
                for k in [k for k in self._store if k[0] == net]:
                    self._nbytes -= self._store.pop(k).nbytes

    def invalidate_keys(self, keys) -> int:
        """Drop an explicit key set (see `KernelCache.key`); returns the
        number actually evicted.  This is the hot-swap path's surgical
        variant of `invalidate`: dropping only the keys the outgoing
        program used -- minus those the incoming one still needs -- so a
        swap never cold-starts the new program's transforms.  Counts once
        in `invalidations` when anything was dropped.

        On the card an evicted transform's device memory goes back to the
        allocator, so call this only once no wave can still read it: after
        `ReplicaPool.swap` has drained the in-flight waves, whose worker
        streams are synchronized before a wave completes."""
        dropped = 0
        with self._lock:
            for k in keys:
                wt = self._store.pop(k, None)
                if wt is not None:
                    self._nbytes -= wt.nbytes
                    dropped += 1
            if dropped:
                self.invalidations += 1
        return dropped

    def keys(self) -> list:
        """Snapshot of resident keys, most-recently-used last."""
        with self._lock:
            return list(self._store)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def entry_nbytes(self, key: Tuple) -> Optional[int]:
        """Resident bytes of one transform (None when not resident) --
        the fleet's replicate-vs-shard placement decision reads this."""
        with self._lock:
            wt = self._store.get(key)
            return None if wt is None else int(wt.nbytes)

    def place(self, key: Tuple, put_fn) -> bool:
        """Re-store one resident transform through ``put_fn(wt) -> wt``.
        The placed tensor must be value-identical: placement decides
        where bytes live, never what is served, so a change of shape,
        dtype or device is refused (on one card placement never moves
        bytes).  Returns False when the key is not resident."""
        with self._lock:
            wt = self._store.get(key)
            if wt is None:
                return False
            placed = put_fn(wt)
            if (placed.shape != wt.shape or placed.dtype != wt.dtype
                    or placed.device != wt.device):
                raise ValueError(
                    f"placement changed entry {key}: {tuple(wt.shape)}/"
                    f"{wt.dtype}/{wt.device} -> {tuple(placed.shape)}/"
                    f"{placed.dtype}/{placed.device}"
                )
            self._store[key] = placed
            return True

    def corrupt_entry(self, key: Optional[Tuple] = None) -> Optional[Tuple]:
        """FAULT-INJECTION surface (fleet drills / tests only): replace
        one resident transform by its negation, silently poisoning every
        future fetch of it -- the failure mode a bit-flipped shared cache
        would produce.  Targets the least-recently-used entry when no key
        is given.  Returns the corrupted key (None when the cache is
        empty).  The negation is a new tensor, published like every other
        memo write (`invalidate_keys` says why: an entry must not change
        under a stream that may still read it).  Detection and repair are
        the fleet pool's health-probe job; the cache itself stays silent,
        which is the point."""
        with self._lock:
            if key is None:
                key = next(iter(self._store), None)
            if key is None or key not in self._store:
                return None
            self._store[key] = publish(-self._store[key])
            return key

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "entries": len(self._store),
                "bytes": self._nbytes,
                "capacity_bytes": self.capacity_bytes,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
