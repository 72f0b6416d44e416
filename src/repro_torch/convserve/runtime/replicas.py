"""Replica pool: N executors of one net sharing one `KernelCache`.

The paper's pre-transformed kernels are the expensive shared state --
the whole point of the cache is that transforms are prepared ONCE and
served everywhere, so replicas must share it (the cache is internally
locked).  Each replica owns its executor; waves are dispatched to the
least-loaded replica on a thread pool, with per-replica in-flight and
dispatch accounting.  `workers=0` runs waves inline on the caller's
thread -- the deterministic mode the simulated-clock tests use (no
thread interleaving, same results, same counters).

On the card each worker thread runs its waves on a CUDA stream of its
own on the replica's card (one stream per thread and card) and copies
the result to the host on that stream, so replicas overlap on the
device.  The shared state they read -- cached kernel
transforms, packed right-hand matrices, basis matrices -- is prepared in
`warmup` on the caller's thread, which then synchronizes the device
before any wave is served; an entry first made during serving is
published only after the stream that made it has finished
(`core.device.publish`).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import dataclasses

import numpy as np
import torch

from repro_torch.convserve.runtime.clock import Clock, RealClock
from repro_torch.convserve.runtime.scheduler import Wave
from repro_torch.core.device import host_array, thread_stream


@dataclasses.dataclass
class WaveResult:
    """One executed wave: per-request outputs plus where/how long.
    `compiled` marks a cold wave (the replica served this input shape
    for the first time): its wall time carries first-use set-up, so the
    runtime keeps it out of the deadline-slack service estimate."""

    wave: Wave
    outputs: Dict[int, np.ndarray]  # rid -> (H', W', C')
    replica: int
    compute_s: float
    compiled: bool = False


class ReplicaPool:
    """Dispatches waves across replicas of one compiled net.

    `executors` are callables ``ex(batch, sizes)`` exposing ``spec`` and
    ``cache`` (both `NetExecutor` and `engine.CompiledNet` qualify) that
    were built against the SAME `KernelCache` -- asserted here, because
    separate caches would silently re-transform every kernel per
    replica.
    """

    def __init__(self, executors: Sequence, *, workers: Optional[int] = None,
                 clock: Optional[Clock] = None):
        if not executors:
            raise ValueError("replica pool needs at least one executor")
        cache = executors[0].cache
        spec = executors[0].spec
        for ex in executors[1:]:
            if ex.cache is not cache:
                raise ValueError(
                    "replicas must share one KernelCache (pass the same "
                    "cache/Engine when compiling each replica)"
                )
            if ex.spec is not spec and ex.spec != spec:
                raise ValueError("replicas must serve the same NetSpec")
        self.spec = spec
        self.cache = cache
        self.clock = clock or RealClock()
        self.workers = len(executors) if workers is None else workers
        self._pool = (
            ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="replica"
            )
            if self.workers > 0
            else None
        )
        self._lock = threading.Lock()
        self.executors = list(executors)  # guarded-by: _lock
        self.in_flight = [0] * len(executors)  # guarded-by: _lock
        self.dispatched = [0] * len(executors)  # guarded-by: _lock

    @classmethod
    def build(cls, engine, spec, weights, n: int, *,
              workers: Optional[int] = None,
              clock: Optional[Clock] = None, **compile_kwargs):
        """Compile `n` replicas of one net on one engine (hence one
        shared cache) and pool them.  The net is PLANNED once; replicas
        2..n bind the first replica's plan -- planning n times would be
        redundant roofline work, and with measurement-backed knobs
        (``tune_r=True``) could even hand different replicas different
        programs, breaking the pool's shared-shape assumption."""
        first = engine.compile(spec, weights, **compile_kwargs)
        fuse = compile_kwargs.get("fuse", True)
        nets = [first] + [
            engine.compile(spec, weights, plan=first.plan, fuse=fuse)
            for _ in range(n - 1)
        ]
        return cls(nets, workers=workers, clock=clock)

    # ------------------------------------------------------- dispatch

    def _pick(self):
        """Least-loaded replica; dispatch count breaks ties so the
        synchronous mode still spreads waves across replicas.  Returns
        ``(index, executor)`` -- the executor is read under the same
        lock, so a concurrent `swap` cannot slip between pick and run."""
        with self._lock:
            i = min(
                range(len(self.executors)),
                key=lambda j: (self.in_flight[j], self.dispatched[j], j),
            )
            self.in_flight[i] += 1
            self.dispatched[i] += 1
            return i, self.executors[i]

    def _forward(self, ex, batch, sizes) -> np.ndarray:
        """One wave through `ex`, its output on the host.  A threaded
        pool runs a card replica on the worker's own stream: the input
        copy, the kernels and the copy back all queue there, and the
        thread waits for that stream alone."""
        dev = replica_device(ex)
        if self._pool is None or dev is None or dev.type != "cuda":
            return _host(ex(batch, sizes))
        stream = thread_stream(dev)
        with torch.cuda.stream(stream):
            y = _host(ex(batch, sizes))
        stream.synchronize()
        return y

    def _run(self, i: int, ex, wave: Wave) -> WaveResult:
        try:
            batch, sizes = wave.assemble()
            before = ex.compile_count
            t0 = self.clock.now()
            y = self._forward(ex, batch, sizes)
            dt = self.clock.now() - t0
            return WaveResult(
                wave=wave, outputs=wave.crop(self.spec, y),
                replica=i, compute_s=dt,
                compiled=ex.compile_count > before,
            )
        finally:
            with self._lock:
                self.in_flight[i] -= 1

    def submit(self, wave: Wave) -> "Future[WaveResult]":
        """Run the wave on the least-loaded replica.  Returns a Future;
        with ``workers=0`` it is already completed (inline execution)."""
        i, ex = self._pick()
        if self._pool is None:
            fut: Future = Future()
            try:
                fut.set_result(self._run(i, ex, wave))
            except BaseException as e:  # mirror executor.submit semantics
                fut.set_exception(e)
            return fut
        return self._pool.submit(self._run, i, ex, wave)

    def run(self, wave: Wave) -> WaveResult:
        """Synchronous convenience wrapper."""
        return self.submit(wave).result()

    def swap(self, executors: Sequence, *, timeout_s: float = 5.0) -> list:
        """Atomically replace every replica's executor with `executors`
        (the hot-swap path).  Waits for all in-flight waves to drain on
        the OLD program first -- the drain check and the flip happen
        under the dispatch lock, so no wave can be picked between them.
        Returns the outgoing executors (the caller diffs their cache
        keys against the new ones to invalidate stale transforms).
        """
        new = list(executors)
        if len(new) != len(self.executors):
            raise ValueError(
                f"swap needs {len(self.executors)} executors, got {len(new)}"
            )
        for ex in new:
            if ex.cache is not self.cache:
                raise ValueError(
                    "swapped-in replicas must share the pool's KernelCache"
                )
            if ex.spec is not self.spec and ex.spec != self.spec:
                raise ValueError("swapped-in replicas must serve the same NetSpec")
        deadline = self.clock.now() + timeout_s
        while True:
            with self._lock:
                if sum(self.in_flight) == 0:
                    old = self.executors
                    self.executors = new
                    return old
            if self.clock.now() > deadline:
                raise TimeoutError(
                    f"in-flight waves did not drain within {timeout_s}s"
                )
            self.clock.sleep(0.001)

    def has_capacity(self) -> bool:
        """Whether a dispatched wave would start immediately.  The
        runtime gates wave formation on this: dispatching into a
        saturated pool would just move the queue somewhere batching
        can no longer reach it."""
        if self._pool is None:
            return True
        with self._lock:
            return sum(self.in_flight) < self.workers

    def warmup(self, buckets: Sequence[int],
               batch_sizes: Sequence[int]) -> None:
        """Compile every (bucket, batch size) program on EVERY replica
        and prepare the shared transforms, using all-padding waves
        (batch rows of extent 0 are fully masked, so warmup computes
        zeros and cannot affect any served output).  Runs on the
        caller's thread and stream, then synchronizes every card the
        replicas use: what warmup prepared is complete before any
        replica stream reads it.  A threaded pool on the card then runs
        the same waves once on every worker thread, on its own stream:
        a thread's first waves there pay for its stream, its library
        handles and its allocator pool (tens to hundreds of ms), which
        would otherwise land on the first served waves."""
        c0 = self.spec.conv_layers()[0][1].c_in
        waves = [(np.zeros((s, b, b, c0), np.float32), np.zeros((s, 2), np.int32))
                 for b in buckets for s in batch_sizes]
        for ex in self.executors:
            for x, sizes in waves:
                _host(ex(x, sizes))
        cards = {replica_device(ex) for ex in self.executors} - {None}
        cards = {dev for dev in cards if dev.type == "cuda"}
        for dev in cards:
            torch.cuda.synchronize(dev)
        self.warm_workers(self.executors, waves)

    def warm_workers(self, executors: Sequence, waves: Sequence) -> None:
        """Run `waves` ((batch, sizes) pairs) once on every worker thread
        of a threaded pool on the card, each on its own stream, through
        `executors` (worker i takes executor i mod n): a thread's first
        waves on its stream pay for the stream, its library handles and
        its allocator pool.  Their shared memo entries must already be
        made and synchronized by the caller.  Does nothing for an inline
        pool or off the card."""
        cards = {replica_device(ex) for ex in executors} - {None}
        if self._pool is None or not any(d.type == "cuda" for d in cards):
            return
        # one task per worker thread: each waits at the barrier until all
        # are running, so no thread takes two
        barrier = threading.Barrier(self.workers)

        def warm(i: int) -> None:
            barrier.wait(timeout=60.0)
            ex = executors[i % len(executors)]
            for x, sizes in waves:
                self._forward(ex, x, sizes)

        for fut in [self._pool.submit(warm, i) for i in range(self.workers)]:
            fut.result()

    # ---------------------------------------------------------- stats

    def profile_stages(self, side: int, batch: int = 1) -> List[tuple]:
        """Per-stage wall times on replica 0 at a bucket geometry (the
        telemetry snapshot's stage rollup)."""
        c0 = self.spec.conv_layers()[0][1].c_in
        x = np.zeros((batch, side, side, c0), np.float32)
        return self.executors[0].profile_stages(x)

    def stats(self) -> dict:
        with self._lock:
            per_replica = {
                "dispatched": list(self.dispatched),
                "in_flight": list(self.in_flight),
            }
            executors = list(self.executors)
        return {
            "replicas": len(executors),
            "workers": self.workers,
            **per_replica,
            "compiled_programs": sum(
                ex.compile_count for ex in executors
            ),
            "cache": self.cache.stats(),
        }

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def replica_device(ex) -> "torch.device | None":
    """The device a pool executor runs on (`NetExecutor.device`, through
    a `CompiledNet`), None when it names none."""
    dev = getattr(ex, "device", None)
    if dev is None:
        dev = getattr(getattr(ex, "executor", None), "device", None)
    return dev


def _host(y) -> np.ndarray:
    """A wave's output as a host array (the copy waits for the stream it
    was queued on)."""
    if isinstance(y, torch.Tensor):
        return host_array(y)
    return np.asarray(y)
