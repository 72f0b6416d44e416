"""Batched serving engine: prefill + decode over request waves.

Requests arrive with prompts and are served in waves of up to
`max_batch`: the wave's prompts are right-aligned into one (B, S) batch
and prefilled together, then decoded step by step with greedy or
temperature sampling on the host (numpy's generator, seeded per run);
a request stops at its `max_new_tokens` or at `eos_id`.  The model runs
on its own device; sampling reads the logits back every step, so each
step's host time is device time plus the host's own.

`waves` records, per wave: its size, prompt length, prefill and decode
seconds (host clock, after the logits reached the host) and decode steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.models import lm as lm_mod


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0
    eos_id: int = -1  # -1: never stop early


class Engine:
    def __init__(self, model: lm_mod.LM, scfg: ServeConfig):
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.waves: List[Dict] = []

    def _sample(self, logits: torch.Tensor, rng: np.random.Generator) -> np.ndarray:
        if self.scfg.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        probs = probs.cpu().numpy()
        return np.array(
            [rng.choice(probs.shape[-1], p=pr) for pr in probs], np.int32
        )

    def run(self, requests: List[Request], seed: int = 0) -> Dict[int, List[int]]:
        """Serve a list of requests in batched waves."""
        rng = np.random.default_rng(seed)
        results: Dict[int, List[int]] = {}
        queue = list(requests)
        while queue:
            wave = queue[: self.scfg.max_batch]
            queue = queue[self.scfg.max_batch :]
            results.update(self._run_wave(wave, rng))
        return results

    def _run_wave(self, wave: List[Request], rng) -> Dict[int, List[int]]:
        b = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(wave):  # left-pad-free: right-align prompts
            toks[i, plen - len(r.prompt) :] = r.prompt
        dev = self.model.device
        t0 = time.perf_counter()
        logits, state = lm_mod.lm_prefill(
            self.model, torch.from_numpy(toks).to(dev), self.scfg.max_len
        )
        cur = self._sample(logits, rng)
        t1 = time.perf_counter()
        outs: Dict[int, List[int]] = {r.rid: [] for r in wave}
        done = np.zeros(b, bool)
        steps = 0
        max_new = max(r.max_new_tokens for r in wave)
        for t in range(max_new):
            for i, r in enumerate(wave):
                if not done[i] and t < r.max_new_tokens:
                    outs[r.rid].append(int(cur[i]))
                    if cur[i] == self.scfg.eos_id:
                        done[i] = True
            if done.all():
                break
            logits, state = lm_mod.lm_decode_step(
                self.model, torch.from_numpy(cur.astype(np.int64)).to(dev),
                plen + t, state,
            )
            cur = self._sample(logits, rng)
            steps += 1
        self.waves.append(dict(
            size=b, prompt_len=plen, prefill_s=t1 - t0,
            decode_s=time.perf_counter() - t1, decode_steps=steps,
            tokens=sum(len(v) for v in outs.values()),
        ))
        return outs
