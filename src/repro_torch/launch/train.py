"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --reduced \
        --device cpu --steps 3 --batch 8 --seq 128 --ckpt-dir build/ckpt

Trains on the CUDA card unless `--device` names another device (without
a card and without `--device` it raises).  The flags are the
reference's (`src/repro/launch/train.py`) plus `--device`.  The model
trains in its config's dtype, as the reference's launcher trains it: bf16
for a registered config, fp32 for `--reduced` (whose config is f32).
Weights come from `--seed`, data
from the reference's synthetic `TokenStream`.  The reference calls
`jax.distributed.initialize` on a multi-host cluster; one card has no
counterpart, so this process is the whole job.  Fault tolerance
(restore-on-failure, SIGTERM save) lives in `repro_torch.train.loop`.

`main` returns the final train state and one record per step (step,
loss, grad_norm, seconds; and, where the step reports them, nll, the
main NLL, moe_aux and moe_z, the MoE aux losses summed over the stack,
and mtp_nll, the MTP head's NLL of an MTP config such as
deepseek-v3-671b).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


# the step's metrics a record carries where the step reports them
RECORDED = ("nll", "moe_aux", "moe_z", "mtp_nll")


def main(argv=None) -> Tuple[Dict, List[Dict[str, float]]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        remat=True,
        warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps,
    )
    state = init_train_state(cfg, tcfg, args.seed, device)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.2f}M {cfg.dtype} on {device} "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    step_fn = make_train_step(cfg, tcfg)
    stream = TokenStream(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    )
    history: List[Dict[str, float]] = []

    def record(step, metrics, dt):
        history.append(dict(step=step, loss=float(metrics["loss"]),
                            grad_norm=float(metrics["grad_norm"]), seconds=dt,
                            **{k: float(metrics[k]) for k in RECORDED if k in metrics}))

    state = train_loop(
        state=state,
        train_step=step_fn,
        next_batch=stream.batch_at,
        cfg=LoopConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            log_every=10,
        ),
        on_step=record,
    )
    return state, history


if __name__ == "__main__":
    main()
