"""Zero-downtime plan hot swap.

Promotion is three ordered moves, each safe on its own:

1. **Warm** the candidate executors at every (bucket, batch-size) shape
   the scheduler has ever dispatched (`WaveScheduler.compiled_sizes`),
   using all-padding waves -- after this, no live request pays for the
   new program's first-use set-up (cached transforms, packed right-hand
   matrices, the kernels' launch plans).  On the card the waves run on
   the caller's stream, the device is synchronized (so every memo entry
   they made is complete before another stream reads it), and then once
   on every worker thread's own stream (`ReplicaPool.warm_workers`).
2. **Flip** dispatch: `ReplicaPool.swap` waits for in-flight waves to
   drain on the old program and switches the executor list under the
   dispatch lock, so every wave runs wholly on one program or the other
   -- never a mix, never a drop.
3. **Invalidate** surgically: the old program's `KernelCache` keys MINUS
   the keys the new program still uses are evicted.  A promotion that
   keeps some layers' algorithms keeps their transforms resident.  This
   runs only after the drain: a drained wave's worker stream has
   finished, so no kernel can still read an evicted device tensor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.convserve.runtime.replicas import replica_device


def warm_executors(
    executors: Sequence,
    sizes_by_bucket: dict,
) -> int:
    """Run every (bucket, batch size) program on every candidate
    executor with all-padding waves, built on the executor's own device
    (extent-0 rows are fully masked, so warming computes zeros and
    cannot affect any served output), then synchronize every card they
    ran on.  Returns the number of programs warmed."""
    n = 0
    cards = set()
    for ex in executors:
        dev = replica_device(ex)
        c0 = ex.spec.conv_layers()[0][1].c_in
        for bucket, sizes in sizes_by_bucket.items():
            for s in sizes:
                x = torch.zeros((s, bucket, bucket, c0), device=dev)
                ex(x, torch.zeros((s, 2), dtype=torch.int32, device=dev))
                n += 1
        if dev is not None and dev.type == "cuda":
            cards.add(dev)
    for dev in cards:
        torch.cuda.synchronize(dev)
    return n


def hot_swap(
    pool,
    candidates: Sequence,
    *,
    scheduler=None,
    timeout_s: float = 5.0,
    invalidate: bool = True,
    verify: bool = True,
) -> list:
    """Promote `candidates` into `pool` with zero downtime.

    With ``verify`` (default), any candidate exposing a spec + plan is
    first run through the static IR verifier against the hardware model
    it was compiled for (`CompiledNet.hw`) — a failing candidate raises
    `VerificationError` BEFORE any warmup or drain, so a corrupted plan
    can never flip into live dispatch.  (The adapt loop verifies again
    earlier, at candidate-planning time; this is the last line of
    defense for hand-rolled swaps.)

    Warms at the scheduler's compiled shapes (skipped when no scheduler
    is passed), drains + flips dispatch atomically, then drops the old
    program's now-orphaned cache entries.  Returns the outgoing
    executors (the rollback path keeps them warm by simply swapping
    them back)."""
    if verify:
        from repro_torch.convserve.check.diagnostics import VerificationError
        from repro_torch.convserve.check.ir import verify_program

        for ex in candidates:
            spec = getattr(ex, "spec", None)
            plan = getattr(ex, "plan", None)
            if spec is None or plan is None:
                continue
            report = verify_program(
                spec, plan,
                program=getattr(ex, "program", None),
                hw=getattr(ex, "hw", None),
            )
            if report.errors:
                raise VerificationError(report)
    if scheduler is not None:
        sizes = scheduler.compiled_sizes()
        warm_executors(candidates, sizes)
        pool.warm_workers(candidates, [
            (np.zeros((s, b, b, pool.spec.conv_layers()[0][1].c_in), np.float32),
             np.zeros((s, 2), np.int32))
            for b, batch_sizes in sizes.items() for s in batch_sizes
        ])
    old = pool.swap(candidates, timeout_s=timeout_s)
    if invalidate:
        old_keys = set()
        new_keys = set()
        for ex in old:
            old_keys.update(ex.cache_keys())
        for ex in pool.executors:
            new_keys.update(ex.cache_keys())
        stale = old_keys - new_keys
        if stale:
            pool.cache.invalidate_keys(stale)
    return old
