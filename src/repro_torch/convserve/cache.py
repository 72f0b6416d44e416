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

An entry is served on the device of the weights that ask for it.  It
lives where it was first prepared until the fleet places it over a
mesh's cards (`place` with a `PlacedTransform`): replicated, each card
keeps a whole copy; sharded, each card keeps one slice and gathers the
others from its peers into a transient buffer at every read, the
all-gather GSPMD would insert (`core.device.transient`: what a kernel
derives from that buffer is made for the read and never published, so
a read holds no host synchronisation).  An unplaced entry asked for on
another card is copied there once and the copy kept beside it until the
entry is dropped or placed.  `placement_stats` counts both.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.convserve.plan import LayerPlan
from repro_torch.core.device import canonical, dtype_name, publish, transient


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


class PlacedTransform:
    """One transform placed over the cards of a mesh.

    `devices` are the mesh's positions and `slice_of` the slice each one
    holds: with `dim` None there is one slice, the whole transform, and
    every card keeps a copy (REPLICATE); otherwise the transform is cut
    into ``max(slice_of) + 1`` equal slices along `dim` and each position
    keeps its own (SHARD).  Positions on one card share what they hold.
    The source tensor's bytes are not kept: a card that serves its own
    slice holds a copy of it, never a view of the whole.  `shape`,
    `dtype` and `device` (the card the transform was prepared on) are
    the source's, so placement never changes what an entry is; `on`
    gives it back whole, bitwise."""

    def __init__(self, wt: torch.Tensor, devices: Sequence, slice_of: Sequence[int],
                 dim: Optional[int]):
        n = max(slice_of) + 1
        if len(devices) != len(slice_of) or (dim is None) != (n == 1):
            raise ValueError(f"{len(devices)} devices, slices {list(slice_of)}, dim {dim}")
        if dim is not None and wt.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(wt.shape)} does not split {n} ways")
        self.shape, self.dtype, self.device = wt.shape, wt.dtype, wt.device
        self.dim, self.n_slices = dim, n
        pieces = torch.tensor_split(wt, n, dim) if dim is not None else (wt,)
        home = canonical(wt.device)
        self._held: Dict[Tuple[torch.device, int], torch.Tensor] = {}
        self.holds = []  # each position's key into `_held`: (card, slice)
        for dev, k in zip(devices, slice_of):
            key = (canonical(dev), int(k))
            if key not in self._held:
                piece = pieces[k]
                if key[0] != home:
                    piece = piece.to(key[0])
                elif dim is not None:
                    piece = piece.clone()  # its own bytes, not a view of the whole
                self._held[key] = publish(piece.contiguous())
            self.holds.append(key)
        self.cards = frozenset(card for card, _ in self._held)

    @property
    def nbytes(self) -> int:
        """The whole transform's bytes (the cache's budget counts these)."""
        return self.shape.numel() * self.dtype.itemsize

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def on(self, device) -> torch.Tensor:
        """The whole transform on `device`, one of the mesh's cards: its
        resident copy, or its slices gathered from wherever they are
        kept into a fresh buffer, in order."""
        card = canonical(device)
        if card not in self.cards:
            raise ValueError(f"transform placed on {sorted(map(str, self.cards))}, not {card}")
        if self.dim is None:
            return self._held[(card, 0)]
        parts = []
        for k in range(self.n_slices):
            part = self._held.get((card, k))
            if part is None:  # from a peer that keeps slice k
                part = next(t for (c, s), t in self._held.items() if s == k).to(card)
            parts.append(part)
        return transient(torch.cat(parts, dim=self.dim))

    def gathered_bytes(self, device) -> int:
        """The bytes a read on `device` copies from other cards."""
        card = canonical(device)
        if self.dim is None:
            return 0
        held = {s for c, s in self._held if c == card}
        return (self.n_slices - len(held)) * self.nbytes // self.n_slices

    def bytes_at(self, position: int) -> int:
        """The bytes mesh position `position` keeps resident."""
        return self._held[self.holds[position]].nbytes

    def resident_bytes(self) -> Dict[str, int]:
        """The bytes each card keeps resident (positions on one card share)."""
        out: Dict[str, int] = {}
        for (card, _), t in self._held.items():
            out[str(card)] = out.get(str(card), 0) + t.nbytes
        return out

    def __neg__(self) -> "PlacedTransform":
        """Every held copy and slice negated, in new tensors (the fault
        drill's cache corruption)."""
        out = copy.copy(self)
        out._held = {k: publish(-t) for k, t in self._held.items()}
        return out


def _resident(entry) -> Dict[str, int]:
    if isinstance(entry, PlacedTransform):
        return entry.resident_bytes()
    return {str(canonical(entry.device)): int(entry.nbytes)}


class KernelCache:
    """Memoized right-hand (transformed-kernel) matrices, optionally
    LRU-bounded to `capacity_bytes` of resident transforms."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
        self._store: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()  # guarded-by: _lock
        # an unplaced entry's copies on other cards, by key and card -- guarded-by: _lock
        self._copies: Dict[Tuple, Dict[torch.device, torch.Tensor]] = {}
        self._lock = threading.RLock()
        self._nbytes = 0  # guarded-by: _lock
        self.capacity_bytes = capacity_bytes
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock
        self.gathers = 0  # reads of a sharded entry -- guarded-by: _lock
        self.copies = 0  # copies of an unplaced entry to another card -- guarded-by: _lock
        self.moved_bytes = 0  # bytes both brought from other cards -- guarded-by: _lock

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
        request.  The transform is computed, and served, on `w`'s
        device (the module docstring says how a placed or unplaced entry
        reaches another card).  Returns None for algorithms with no
        consumable pre-transform (direct conv); those are not counted as
        hits or misses.
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
            else:
                self.misses += 1
        if cached is not None:
            return self._serve(key, cached, w.device)
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

    def _serve(self, key: Tuple, entry, device) -> torch.Tensor:
        """`entry` as a whole tensor on `device`, counting what a read
        brings from other cards (outside the lock: a gather or a copy
        is device work)."""
        if isinstance(entry, PlacedTransform):
            moved = entry.gathered_bytes(device)
            out = entry.on(device)
            if moved:
                with self._lock:
                    self.gathers += 1
                    self.moved_bytes += moved
            return out
        card = canonical(device)
        if canonical(entry.device) == card:
            return entry
        with self._lock:
            held = self._copies.get(key, {}).get(card)
        if held is not None:
            return held
        # once per (entry, card): published, since every stream reads it
        held = publish(entry.to(card))
        with self._lock:
            if self._store.get(key) is entry:  # not dropped or placed meanwhile
                kept = self._copies.setdefault(key, {})
                if card not in kept:
                    kept[card] = held
                    self.copies += 1
                    self.moved_bytes += int(entry.nbytes)
                held = kept[card]
        return held

    def _drop(self, key: Tuple):
        # holds-lock: _lock
        """Take `key`'s entry and its copies out of the store."""
        self._copies.pop(key, None)
        entry = self._store.pop(key, None)
        if entry is not None:
            self._nbytes -= entry.nbytes
        return entry

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
            self._drop(key)
            self.evictions += 1

    def invalidate(self, net: Optional[str] = None) -> None:
        """Drop entries (all, or one net's) -- call after a weight
        update.  Each call counts once in `invalidations`, so weight
        churn is visible in serving stats."""
        with self._lock:
            self.invalidations += 1
            if net is None:
                self._store.clear()
                self._copies.clear()
                self._nbytes = 0
            else:
                for k in [k for k in self._store if k[0] == net]:
                    self._drop(k)

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
                if self._drop(k) is not None:
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
        """Re-store one resident transform through ``put_fn(wt) -> wt``,
        `wt` being the whole transform on the card it was prepared on
        (gathered, when the entry is already placed).  Placement decides
        where bytes live, never what is served: a change of shape, dtype
        or device is refused, and a device change is taken only as a
        `PlacedTransform` over a mesh whose whole transform, read back on
        the entry's card, is bitwise `wt`.  Returns False when the key is
        not resident."""
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                return False
            wt = entry.on(entry.device) if isinstance(entry, PlacedTransform) else entry
            placed = put_fn(wt)
            if (placed.shape != wt.shape or placed.dtype != wt.dtype
                    or placed.device != wt.device):
                raise ValueError(
                    f"placement changed entry {key}: {tuple(wt.shape)}/"
                    f"{wt.dtype}/{wt.device} -> {tuple(placed.shape)}/"
                    f"{placed.dtype}/{placed.device}"
                )
            if isinstance(placed, PlacedTransform) and not torch.equal(
                    placed.on(wt.device), wt):
                raise ValueError(f"placement changed entry {key}'s values")
            self._copies.pop(key, None)
            self._store[key] = placed
            return True

    def placement_stats(self) -> dict:
        """How the resident transforms are placed: entries placed over a
        mesh (replicated / sharded), the resident bytes each card keeps
        (an unplaced entry's kept copies included), and the bytes brought
        from other cards: the reads that gathered a sharded entry and the
        copies made of an unplaced one."""
        with self._lock:
            entries = list(self._store.values())
            entries += [t for kept in self._copies.values() for t in kept.values()]
            out = {"replicated": 0, "sharded": 0, "gathers": self.gathers,
                   "copies": self.copies, "moved_bytes": self.moved_bytes}
        resident: Dict[str, int] = {}
        for e in entries:
            if isinstance(e, PlacedTransform):
                out["sharded" if e.sharded else "replicated"] += 1
            for card, nb in _resident(e).items():
                resident[card] = resident.get(card, 0) + nb
        out["resident_bytes"] = resident
        return out

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
            self._copies.pop(key, None)
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
