"""Sharded wave execution over a mesh's data axis.

A wave is a batch of like-bucketed images; its rows are independent, so
the fleet splits them into shards and reassembles the outputs in request
order -- including ragged waves, whose per-sample extent rows travel with
their image rows, so the executor's masking keeps every shard exact.  A
shard is a smaller batch than its wave: the tile kernel may pick another
launch geometry for it and the library convolutions another algorithm,
so a sharded wave equals the unsharded one within the kernels' own
tolerance, not bit for bit.

Two execution paths, picked per wave, as the reference's are, and each
counted in `ShardedWaveExecutor.stats()`:

  * **mesh path** -- when the mesh's ``data`` axis is larger than 1 and
    the wave's rows divide by it: the rows are split as
    `distributed.sharding.batch_spec` splits a batch (over (pod, data)
    when they divide, else over data), and each shard runs on the first
    card of its group (`shard_devices`), through a net compiled from the
    replica's one plan for that card, sharing its weights and kernel
    cache.  Every shard's rows, extents and transforms reach its card
    before any card's kernels are issued; then every shard is issued
    before any is waited on, each on a stream of its card, from the
    caller's one thread (a thread a card was measured slower: the
    executor's Python holds the GIL); the outputs are copied back to the
    wave's card (``mesh.devices[0]``) and concatenated in request order.
    A failure on any card raises: it never falls back to the logical
    path.
  * **logical path** -- otherwise (no mesh, a ``data`` axis of 1, or
    rows that do not divide) the rows are split into `shards`
    contiguous groups run back to back through the replica's one
    program on its own device, then concatenated.  On one card this
    buys nothing in wall time, but the fleet's discrete-event
    simulation charges a sharded wave ``~service/shards`` of *simulated*
    time, which is what the scale-out curve measures.

Weight-cache **replication vs. sharding** is a planner decision, not a
default (`plan_weight_placement`): a small pre-transformed kernel is
cheapest replicated on every device; a large transformed kernel stack
(the paper's 4 C C' T^2 matrices at high channel counts) is sharded
over the mesh so the fleet's resident-transform footprint stays flat as
devices grow.  `apply_placement` carries the decision out on the
resident cache entries (`KernelCache.place` with a `PlacedTransform`):
REPLICATE keeps a whole copy on every mesh card, SHARD one slice of the
last dim that divides by the ``data`` axis on each, gathered from the
peers at every read (the reference's divisibility fallback replicates a
layer whose dims do not divide).  Neither changes what is served.  With
no mesh or a ``data`` axis of 1 placement moves nothing: every layer
counts as skipped.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.device import canonical, thread_stream
from repro_torch.convserve.cache import PlacedTransform
from repro_torch.convserve.executor import NetExecutor
from repro_torch.distributed.sharding import (
    axis_coordinates,
    batch_spec,
    shard_devices,
)

REPLICATE = "replicate"
SHARD = "shard"

# below this, a transformed kernel stack is cheaper replicated than the
# all-gather it would cost sharded (the mesh analogue of the planner's
# shared-level residency gate)
DEFAULT_SHARD_THRESHOLD_BYTES = 1 << 20


def shard_bounds(n: int, shards: int) -> List[Tuple[int, int]]:
    """Contiguous, balanced row ranges: `n` rows into at most `shards`
    non-empty ``(lo, hi)`` slices, earlier shards taking the remainder
    (the same split a data axis of size `shards` would produce)."""
    if n <= 0 or shards <= 0:
        return []
    shards = min(shards, n)
    base, rem = divmod(n, shards)
    bounds = []
    lo = 0
    for i in range(shards):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _data_axis_size(mesh) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape.get("data", 1))


def plan_weight_placement(
    net,
    *,
    threshold_bytes: int = DEFAULT_SHARD_THRESHOLD_BYTES,
) -> Dict[int, dict]:
    """Per-conv-layer placement decision: ``{layer: {placement, bytes,
    why}}``.

    Prefers the ACTUAL resident transform bytes (post-warmup cache
    entries); falls back to the closed-form t^2 C C' estimate per
    transform family when a layer has not been prepared yet.  Layers
    whose algorithm consumes no pre-transform (direct) have nothing to
    place and replicate trivially.  The decision is the layer's alone,
    whatever the mesh (the reference's takes one and reads nothing of
    it); `apply_placement` carries it out over a mesh."""
    resident = {k[1]: k for k in net.cache_keys()}
    out: Dict[int, dict] = {}
    for p in net.plan.layers:
        alg = registry.get(p.algo)
        if not alg.consumes_wt:
            out[p.layer] = {
                "placement": REPLICATE, "bytes": 0,
                "why": "no pre-transformed kernels",
            }
            continue
        key = resident.get(p.layer)
        nb = net.cache.entry_nbytes(key) if key is not None else None
        why = "resident transform bytes"
        if nb is None:
            s = p.spec
            t = p.params.get("t") or (p.params.get("r", 2) + s.k - 1)
            elem = 8 if getattr(alg, "chain_family", "") == "fft" else 4
            nb = t * t * s.c_in * s.c_out * elem // max(s.groups, 1)
            why = "estimated (not yet prepared)"
        out[p.layer] = {
            "placement": SHARD if nb >= threshold_bytes else REPLICATE,
            "bytes": int(nb),
            "why": why,
        }
    return out


def apply_placement(net, mesh, placement: Dict[int, dict]) -> dict:
    """Carry a `plan_weight_placement` decision out on the resident
    cache entries over the mesh's cards: a SHARD layer keeps one slice of
    its last dim that divides by the ``data`` axis on each card (the
    slice of the card's ``data`` coordinate; a layer with no such dim is
    replicated, as the reference's divisibility fallback does), a
    REPLICATE layer a whole copy on each.  With no mesh, or a ``data``
    axis of 1, placement moves nothing.  Returns ``{sharded, replicated,
    skipped}`` counts (a SHARD decision counts as sharded, as in the
    reference, whether or not a dim divided)."""
    counts = {"sharded": 0, "replicated": 0, "skipped": 0}
    ndata = _data_axis_size(mesh)
    if mesh is None or ndata <= 1:
        counts["skipped"] = len(placement)
        return counts
    shard_devices(mesh, None)  # a logical mesh holds no card: raises
    coords = axis_coordinates(mesh, "data")
    resident = {k[1]: k for k in net.cache_keys()}
    for layer, decision in placement.items():
        key = resident.get(layer)
        if key is None:
            counts["skipped"] += 1
            continue
        want_shard = decision["placement"] == SHARD

        def put(wt, want_shard=want_shard):
            # the last dim divisible by the data axis -- transform families
            # lay kernels out differently, but all keep channel-like dims
            # trailing
            dim = None
            if want_shard:
                dim = next((d for d in range(wt.ndim - 1, -1, -1)
                            if wt.shape[d] % ndata == 0 and wt.shape[d] >= ndata), None)
            slices = coords if dim is not None else (0,) * mesh.size
            return PlacedTransform(wt, mesh.devices, slices, dim)

        if net.cache.place(key, put):
            counts["sharded" if want_shard else "replicated"] += 1
        else:
            counts["skipped"] += 1
    return counts


class ShardedWaveExecutor:
    """One replica's executor, wave-sharded over a mesh's data axis (the
    module docstring's two paths).

    Duck-types `CompiledNet` everywhere the pool and the hot-swap path
    care (`spec`/`cache`/`plan`/`program`/`hw`/`compile_count`/
    `profile_stages`/`cache_keys`/`executor`), so an elastic pool of
    sharded replicas composes with everything built for plain ones."""

    def __init__(
        self,
        net,
        *,
        shards: int = 1,
        mesh=None,
    ):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if _data_axis_size(mesh) > 1:
            shard_devices(mesh, None)  # a logical mesh holds no card: raises
        self.net = net
        self.shards = shards
        self.mesh = mesh
        self._lock = threading.Lock()
        # waves by path: "mesh", "logical", and "whole" (one shard or one
        # row: the replica's own net) -- guarded-by: _lock
        self.waves = {"mesh": 0, "logical": 0, "whole": 0}
        self._card_nets: Dict[torch.device, NetExecutor] = {}  # guarded-by: _lock

    # --------------------------------------------------- passthroughs

    @property
    def spec(self):
        return self.net.spec

    @property
    def cache(self):
        return self.net.cache

    @property
    def plan(self):
        return self.net.plan

    @property
    def program(self):
        return self.net.program

    @property
    def hw(self):
        return self.net.hw

    @property
    def executor(self):
        """The inner `NetExecutor` (its `device` says where the replica
        runs; `runtime.replicas.replica_device` reads it through here)."""
        return getattr(self.net, "executor", self.net)

    @property
    def compile_count(self) -> int:
        return self.net.compile_count

    def profile_stages(self, x, sizes=None):
        return self.net.profile_stages(x, sizes)

    def cache_keys(self) -> list:
        return self.net.cache_keys()

    def stats(self) -> dict:
        """The replica's net's counters, with the waves each path served
        (``sharded_waves``) and the mesh cards' own net calls."""
        with self._lock:
            waves = dict(self.waves)
            cards = {str(card): ex.calls for card, ex in self._card_nets.items()}
        return {**self.net.stats(), "sharded_waves": waves, "card_calls": cards}

    def _count(self, path: str) -> None:
        with self._lock:
            self.waves[path] += 1

    # ------------------------------------------------------ execution

    def _card_net(self, card):
        """The net that runs this replica's shards on `card`: the
        replica's own where it runs there, else one compiled from its
        plan for that card (made once), with its weights, cache, dtype,
        clock and tracer."""
        inner = self.executor
        card = canonical(card)
        if card == canonical(inner.device):
            return inner
        with self._lock:
            ex = self._card_nets.get(card)
            if ex is None:
                ex = self._card_nets[card] = NetExecutor(
                    inner.spec, inner.weights, inner.plan, cache=inner.cache,
                    dtype=inner.dtype, clock=inner.clock, device=card,
                    tracer=inner.tracer,
                )
        ex.tracer = inner.tracer
        return ex

    @staticmethod
    def _stream(card: torch.device):
        """The stream a shard on `card` runs on: the current one where the
        caller runs (a pool worker's own), else this thread's own there."""
        if card.type != "cuda" or card.index == torch.cuda.current_device():
            return None
        return thread_stream(card)

    def _mesh_wave(self, x, sizes):
        """The mesh path (module docstring)."""
        spec = batch_spec("wave", tuple(x.shape), self.mesh)
        cards = [canonical(d) for d in shard_devices(self.mesh, spec[0])]
        home = canonical(self.mesh.devices[0])
        bounds = shard_bounds(int(x.shape[0]), len(cards))
        x = torch.as_tensor(x)
        sizes = None if sizes is None else torch.as_tensor(sizes)
        nets = [self._card_net(card) for card in cards]
        streams = [self._stream(card) for card in cards]
        # every shard's rows, extents and transforms on its card first: a
        # copy between cards is queued on the source card's current stream,
        # so one queued after another card's kernels would wait for them
        staged = []
        for (lo, hi), card, net, s in zip(bounds, cards, nets, streams):
            with torch.cuda.stream(s):
                staged.append((x[lo:hi].to(card),
                               None if sizes is None else sizes[lo:hi].to(card),
                               net.transforms()))
        ys = []
        for net, (xs, ss, wts), s in zip(nets, staged, streams):
            with torch.cuda.stream(s):
                ys.append(net(xs, ss, transforms=wts))
        # back to the wave's card in request order; each copy is queued on
        # its shard's stream, and the wave card's current stream waits on it
        out = []
        for y, s in zip(ys, streams):
            with torch.cuda.stream(s):
                out.append(y.to(home))
        return torch.cat(out, dim=0)

    def __call__(self, x, sizes=None):
        n = int(x.shape[0])
        if self.shards <= 1 or n <= 1:
            self._count("whole")
            return self.net(x, sizes)
        ndata = _data_axis_size(self.mesh)
        if ndata > 1 and n % ndata == 0:
            self._count("mesh")
            return self._mesh_wave(x, sizes)
        # logical path: contiguous row groups through the same program on
        # the replica's device, reassembled in order; extents ride their
        # rows, so every shard masks exactly what the whole wave would
        self._count("logical")
        ys = []
        for lo, hi in shard_bounds(n, self.shards):
            ss = None if sizes is None else sizes[lo:hi]
            ys.append(torch.as_tensor(self.net(x[lo:hi], ss)))
        return torch.cat(ys, dim=0)


def probe_image(spec, side: int, *, seed: int = 20240) -> np.ndarray:
    """The fleet's fixed health-probe input: one seeded image at the
    given bucket geometry (deterministic across replicas and runs, and
    bitwise the reference's)."""
    c0 = spec.conv_layers()[0][1].c_in
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((side, side, c0)) * 0.1).astype(np.float32)
