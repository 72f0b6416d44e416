"""Serving launcher: batched requests against a reduced model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu

Runs on the CUDA card unless `--device` names another device.  The model
is the architecture's reduced (smoke) configuration with random weights
from `--seed`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch, list_archs
from repro_torch.models import init_lm
from repro_torch.serve.engine import Engine, Request, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    model = init_lm(cfg, seed=args.seed, device=args.device)
    eng = Engine(
        model, ServeConfig(max_batch=args.max_batch, max_len=256, temperature=0.0)
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 24)).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    results = eng.run(reqs, seed=args.seed)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"[serve] {args.arch} (reduced) on {model.device}: {len(reqs)} requests, "
          f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s, "
          f"batch={args.max_batch})")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:12]}...")


if __name__ == "__main__":
    main()
