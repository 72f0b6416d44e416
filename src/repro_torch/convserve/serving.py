"""Offline batched-serving front-end: the blocking wrapper over the
runtime's wave scheduler.

Requests carry variably-sized HWC images.  Each is assigned the
smallest spatial bucket that holds it, zero-padded there, and batched
with like-bucketed requests into waves of at most `max_batch`; wave
sizes are rounded up to powers of two.  Compiled-program count is
therefore bounded by  #buckets x log2(max_batch)  regardless of
traffic, and every wave after the first reuses the kernel cache's
pre-transformed matrices.  Per-sample true extents ride along to the
executor, whose post-conv masking makes padded serving *exact* -- each
output equals the net run on that image alone (see executor module
docstring).

Wave formation itself -- bucketing, priority/FIFO order, power-of-two
padding with batch-size hysteresis, round-robin across buckets -- is
NOT implemented here: `ConvServer.run` admits every request into the
same `runtime.WaveScheduler` the reference's online runtime uses and drains
it to completion.  The offline path is literally the online scheduler
with all deadlines at infinity, so the two can never disagree about
what a wave is.  Outputs come back as numpy arrays per request id.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.convserve.runtime.queueing import Request
from repro_torch.convserve.runtime.scheduler import RuntimeConfig, WaveScheduler
from repro_torch.core.device import host_array


@dataclasses.dataclass
class ImageRequest:
    rid: int
    image: np.ndarray  # (H, W, C)


@dataclasses.dataclass
class ConvServeConfig:
    max_batch: int = 8
    # spatial buckets (square); every bucket must survive the net's whole
    # downsampling chain (pool windows AND conv strides -- validated by
    # simulating the shape pipeline at server construction).
    buckets: Sequence[int] = (32, 64, 128, 224)
    pad_batch: bool = True  # round wave sizes up to a power of two

    def runtime_config(self) -> RuntimeConfig:
        """The online config this offline surface is a slice of: no
        SLOs, and a queue deep enough that offline admission never
        rejects for depth (run() takes the whole request list at once)."""
        return RuntimeConfig(
            max_batch=self.max_batch,
            buckets=tuple(self.buckets),
            pad_batch=self.pad_batch,
            queue_depth=1 << 30,
            slo_s=None,
        )


class ConvServer:
    """Serves a compiled net (`engine.CompiledNet`, or a bare
    `NetExecutor`) in bucketed waves, blocking until all requests in a
    batch are done."""

    def __init__(self, executor, cfg: ConvServeConfig):
        # scheduler construction validates the net has convs and that
        # every bucket survives the downsampling chain
        self.scheduler = WaveScheduler(executor.spec, cfg.runtime_config())
        self.executor = executor
        self.cfg = cfg

    def run(self, requests: List[ImageRequest]) -> Dict[int, np.ndarray]:
        """Serve all requests in bucketed waves; rid -> output (H', W', C').

        Offline semantics: an inadmissible request (oversized, bad
        shape) raises before anything is computed, so a batch either
        serves completely or fails fast.
        """
        for r in requests:
            rej = self.scheduler.admit(
                Request(rid=r.rid, image=np.asarray(r.image)), now=0.0
            )
            if rej is not None:
                # failed batch must leave no state behind: without the
                # clear, this request's already-admitted mates would
                # leak into the next run()'s waves and results
                self.scheduler.clear()
                raise ValueError(
                    f"request {rej.rid} rejected ({rej.reason}): {rej.detail}"
                )
        results: Dict[int, np.ndarray] = {}
        try:
            while True:
                wave = self.scheduler.drain_wave()
                if wave is None:
                    return results
                batch, sizes = wave.assemble()
                y = host_array(self.executor(batch, sizes))
                results.update(wave.crop(self.executor.spec, y))
        except BaseException:
            # fail-fast means fail CLEAN: an executor error mid-drain
            # must not leave the unserved remainder queued, where the
            # next run() would silently serve it into its own results
            self.scheduler.clear()
            raise

    def stats(self) -> dict:
        """One dict for the serving counters that used to be scattered
        across executor/cache internals: waves served (plus the
        scheduler's partial-wave/admission accounting), per-bucket
        compile counts, and the kernel-cache hit/miss/eviction/
        invalidation accounting."""
        sched = self.scheduler.stats()
        return {
            "waves": sched["waves"],
            "partial_waves": sched["partial_waves"],
            "admitted": sched["admitted"],
            "rejected": sched["rejected"],
            **self.executor.stats(),
        }
