"""Serving launcher: batched requests against a reduced model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --reduced \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --trace serve.trace.json

Runs on the CUDA card unless `--device` names another device.  The model
is the architecture's reduced (smoke) configuration with random weights
from `--seed` (`--reduced`, the training launcher's flag, says so and
changes nothing).  The engine takes any stack the port builds: a
deepseek-v3-671b layer's cache holds MLA's latents (`c_kv`, `k_rope`,
`pos`) where a GQA layer's holds k and v.  `--trace PATH` writes a
Chrome / Perfetto trace of the run through the port's obs: a
``serve:<arch>`` span around the engine's run and one ``request:<rid>``
instant per request, as the reference's launcher writes it.  `main`
returns the results, {rid: generated tokens}.
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
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (always: this launcher serves no other)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome/Perfetto trace of the run here "
        "(e.g. serve.trace.json; view at https://ui.perfetto.dev)",
    )
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
    tracer = None
    if args.trace:
        from repro_torch.convserve.obs import Tracer

        tracer = Tracer()
    t0 = time.monotonic()
    if tracer is not None:
        with tracer.span(f"serve:{args.arch}", "request",
                         requests=len(reqs), max_batch=args.max_batch):
            results = eng.run(reqs, seed=args.seed)
    else:
        results = eng.run(reqs, seed=args.seed)
    dt = time.monotonic() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"[serve] {args.arch} (reduced) on {model.device}: {len(reqs)} requests, "
          f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s, "
          f"batch={args.max_batch})")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:12]}...")
    if tracer is not None:
        from repro_torch.convserve.obs import write_trace

        for rid in sorted(results):
            tracer.instant(f"request:{rid}", "request", tokens=len(results[rid]))
        n = write_trace(tracer, args.trace)
        print(f"[serve] wrote {args.trace} ({n} events)")
    return results


if __name__ == "__main__":
    main()
