"""Data pipeline: deterministic synthetic stream + file-backed token shards.

The port's own copy of `src/repro/data/pipeline.py` (numpy only): the
batches are bitwise the reference's numpy arrays.  They stay on the host;
the train step moves them to the device.

Design points for the 1000+-node posture:
  * host-sharded: each host reads only its slice of the global batch,
    indexed by (host_id, num_hosts) -- no central dispatcher.
  * deterministic & resumable: batch t is a pure function of (seed, t), so
    restart-after-failure replays exactly; no data-loader state in the
    checkpoint beyond the step counter.
  * double-buffered: a background thread prefetches batch t+1 while step t
    runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    path: Optional[str] = None  # file-backed tokens (np.memmap .bin of int32)


class TokenStream:
    """Deterministic synthetic LM stream (markov-ish mixture so loss is
    learnable, not pure noise)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id
        )
        b, s = self.local_batch, cfg.seq_len
        if self._mm is not None:
            n = len(self._mm) - (s + 1)
            starts = rng.integers(0, max(n, 1), size=b)
            seqs = np.stack(
                [self._mm[st : st + s + 1] for st in starts]
            ).astype(np.int32)
            seqs = np.clip(seqs, 0, cfg.vocab_size - 1)
        else:
            # structured synthetic: piecewise-linear token walks
            base = rng.integers(0, cfg.vocab_size, size=(b, 1))
            drift = rng.integers(-3, 4, size=(b, s + 1)).cumsum(axis=1)
            seqs = ((base + drift) % cfg.vocab_size).astype(np.int32)
        return {
            "tokens": seqs[:, :-1],
            "targets": seqs[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """One-deep background prefetch (double buffering)."""

    def __init__(self, stream: TokenStream, start_step: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = stream.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
