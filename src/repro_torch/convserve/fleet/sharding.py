"""Sharded wave execution.

A wave is a batch of like-bucketed images; its rows are independent, so
the fleet splits them into shards and reassembles the outputs in request
order -- including ragged waves, whose per-sample extent rows travel with
their image rows, so the executor's masking keeps every shard exact.  A
shard is a smaller batch than its wave: the tile kernel may pick another
launch geometry for it and the library convolutions another algorithm,
so a sharded wave equals the unsharded one within the kernels' own
tolerance, not bit for bit.

**What a mesh means on one card.**  With ``mesh=None``, or a mesh whose
``data`` axis has size 1, every wave takes the **logical path**: the rows
are split into `shards` contiguous groups run back to back through the
replica's one program on its one device, then concatenated.  On one card
this buys nothing in wall time, but the fleet's discrete-event simulation
charges a sharded wave ``~service/shards`` of *simulated* time, which is
what the scale-out curve measures.  A mesh whose ``data`` axis is larger
than 1 (rows on ``cuda:i``, transforms placed per layer) raises
`NotImplementedError`: that path waits for ROADMAP §1, the multi-card
mesh, and never quietly falls back to the logical one.

Weight-cache **replication vs. sharding** is a planner decision, not a
default (`plan_weight_placement`): a small pre-transformed kernel is
cheapest replicated on every device; a large transformed kernel stack
(the paper's 4 C C' T^2 matrices at high channel counts) is sharded
over the mesh so the fleet's resident-transform footprint stays flat as
devices grow.  On one card there is nothing to move: `apply_placement`
counts every layer as skipped.  Carrying the decision out on the
resident cache entries (`KernelCache.place` per layer) comes with the
multi-card mesh.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import registry

REPLICATE = "replicate"
SHARD = "shard"

# below this, a transformed kernel stack is cheaper replicated than the
# all-gather it would cost sharded (the mesh analogue of the planner's
# shared-level residency gate)
DEFAULT_SHARD_THRESHOLD_BYTES = 1 << 20

MULTI_CARD = (
    "a mesh whose data axis is larger than 1 (rows on cuda:i, transforms "
    "placed per layer) is not ported: ROADMAP §1, the multi-card mesh"
)


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


def _one_card(mesh) -> None:
    """Refuse a mesh this port cannot execute (see the module docstring)."""
    if _data_axis_size(mesh) > 1:
        raise NotImplementedError(MULTI_CARD)


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
    place and replicate trivially."""
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
    cache entries.  On one card (no mesh, or a ``data`` axis of 1)
    placement moves no bytes: every layer counts as skipped.  A larger
    ``data`` axis raises `NotImplementedError`.  Returns ``{sharded,
    replicated, skipped}`` counts."""
    _one_card(mesh)
    return {"sharded": 0, "replicated": 0, "skipped": len(placement)}


class ShardedWaveExecutor:
    """One replica's executor, wave-sharded into row groups.

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
        _one_card(mesh)
        self.net = net
        self.shards = shards
        self.mesh = mesh

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
        return self.net.stats()

    # ------------------------------------------------------ execution

    def __call__(self, x, sizes=None):
        n = int(x.shape[0])
        if self.shards <= 1 or n <= 1:
            return self.net(x, sizes)
        # logical path: contiguous row groups through the same program on
        # the replica's device, reassembled in order; extents ride their
        # rows, so every shard masks exactly what the whole wave would
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
