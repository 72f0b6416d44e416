"""Dry run: every (arch x shape) cell's step on the meta device, counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \
        --shape train_4k [--mesh 1 | --multi-pod | --both-meshes] \
        [--out results/dryrun_torch]

For each cell this runs the step the shape names -- the train step for a
train shape, `lm_prefill` or `lm_decode_step` for an inference shape --
on meta tensors (nothing is allocated, nothing runs) under the op counter
(`hlo_analysis.OpCounter`), and records: each card's bytes of
parameters, gradients, optimizer state, cache and batch from the
sharding builders, whether that state fits one card (80 GiB, or the
card's own memory when one is present), the counted FLOPs and bytes,
each hand-written kernel's calls, the model FLOPs and the roofline terms
at an H100's peaks.  Activations are not counted in `fits`: the meta
device keeps no allocator.

`--mesh 1` (the default) is one card; `--multi-pod` and `--both-meshes`
take the reference's production meshes (16 x 16, 2 x 16 x 16) as
logical meshes: per-card bytes follow the reference's sharding rules,
and the roofline divides the whole step's counts by the cards.  No
collective is ported, so no collective term is counted.  The port has
no runtime flags: it behaves as the reference's defaults (the optimized
implementation), and `--impl baseline` exits naming that decision.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Tuple, Union

import torch

from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    cell_is_defined,
    get_arch,
    list_archs,
)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.hlo_analysis import (
    CARD_BYTES,
    OpCounter,
    Roofline,
    model_flops_infer,
    model_flops_train,
)
from repro_torch.launch.mesh import make_production_mesh

MESHES = ("1", "16x16", "2x16x16")

BASELINE_REFUSED = (
    "--impl baseline: the port has no runtime flags (models/runtime_flags.py is not "
    "ported, by decision: ROADMAP); it behaves as the reference's defaults, the "
    "optimized implementation"
)


def make_mesh(name: str) -> shd.Mesh:
    if name == "1":
        return shd.Mesh({"data": 1, "model": 1}, logical=True)
    return make_production_mesh(multi_pod=name == "2x16x16")


def card_capacity() -> int:
    """One card's memory: the card's own when one is present."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return CARD_BYTES


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig], *,
             mesh: str = "1") -> Tuple[dict, OpCounter]:
    """`lower_cell`'s record and the op counter it read."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    m = make_mesh(mesh)
    per_card = shd.tree_bytes_per_card
    counter = OpCounter()
    t0 = time.monotonic()
    if shape.kind == "train":
        tcfg = S.train_config_for(cfg)
        state = S.train_state_shapes(cfg, tcfg)
        named = dict(state["params"].named_parameters())
        params = shd.shard_params(S.reference_layout(named, cfg), m)
        card = {
            "params": per_card(params),
            "grads": per_card(params),  # each gradient in its parameter's dtype and place
            "opt": (per_card(shd.shard_params(S.reference_layout(state["opt"]["m"], cfg), m))
                    + per_card(shd.shard_params(S.reference_layout(state["opt"]["v"], cfg), m))
                    + per_card(shd.replicated(
                        {"count": state["opt"]["count"], "step": state["step"]}, m))),
        }
        batch = S.batch_specs(cfg, shape)
        card["batch"] = per_card(shd.shard_batch(batch, m))
        with counter:
            S.train_fn(cfg, tcfg)(state, batch)
        mf = model_flops_train(cfg, shape)
    else:
        model = S.param_shapes(cfg)
        named = dict(model.named_parameters())
        card = {"params": per_card(shd.shard_params_for_inference(
            S.reference_layout(named, cfg), m))}
        if shape.kind == "prefill":
            batch = S.prefill_specs(cfg, shape)
            with counter:
                _, state = S.prefill_fn(cfg, shape)(model, batch)
            mf = model_flops_infer(cfg, shape, decode=False)
        else:
            batch = S.decode_specs(cfg, shape)
            state = S.decode_state_shapes(cfg, shape)
            with counter:
                S.decode_fn(cfg)(model, batch["token"], shape.seq_len - 1, state)
            mf = model_flops_infer(cfg, shape, decode=True)
        card["cache"] = per_card(shd.shard_cache(S.reference_cache_layout(state, cfg), m))
        card["batch"] = per_card(shd.shard_batch(
            {k: v for k, v in batch.items() if k != "pos"}, m))
    seconds = time.monotonic() - t0
    rf = Roofline(chips=m.size, hlo_flops=float(counter.flops), hlo_bytes=float(counter.bytes),
                  model_flops=mf, dtype=cfg.dtype)
    capacity = card_capacity()
    state_bytes = sum(card.values())
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh,
        "chips": m.size,
        "kind": shape.kind,
        "dtype": cfg.dtype,
        "count_s": round(seconds, 2),
        "bytes_per_card": card,
        "state_bytes_per_card": state_bytes,
        "card_bytes": capacity,
        "fits": state_bytes <= capacity,
        "counted": {"flops": counter.flops, "bytes": counter.bytes},
        "kernel_calls": counter.kernel_calls(),
        "kernels": {k: vars(s) for k, s in sorted(counter.kernels.items())},
        "model_flops": mf,
        "roofline": rf.as_dict(),
        "status": "ok",
    }
    return rec, counter


def lower_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig], *,
               mesh: str = "1") -> dict:
    """One cell's record: `arch` and `shape` by name or as configs."""
    return run_cell(arch, shape, mesh=mesh)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="1", choices=MESHES,
                    help="1 (one card, the default) or a production mesh")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true", help="16x16 and 2x16x16")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--impl", choices=("baseline", "optimized"), default="optimized",
                    help="the reference's flag: the port runs its defaults only")
    args = ap.parse_args(argv)
    if args.impl == "baseline":
        print(BASELINE_REFUSED, file=sys.stderr)
        return 2

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    elif args.multi_pod:
        meshes = ["2x16x16"]
    else:
        meshes = [args.mesh]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    t_all = time.monotonic()
    for arch in archs:
        for shape in shapes:
            ok, reason = cell_is_defined(get_arch(arch), SHAPES[shape])
            for mesh in meshes:
                tag = f"{arch}__{shape}__{mesh}"
                path = outdir / f"{tag}.json"
                if not ok:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "skipped", "reason": reason}
                    path.write_text(json.dumps(rec, indent=1))
                    print(f"[skip] {tag}: {reason}")
                    continue
                try:
                    rec = lower_cell(arch, shape, mesh=mesh)
                    path.write_text(json.dumps(rec, indent=1))
                    r = rec["roofline"]
                    print(
                        f"[ok]   {tag}: count={rec['count_s']}s "
                        f"state/card={rec['state_bytes_per_card'] / 2**30:.2f}GiB "
                        f"fits={rec['fits']} bottleneck={r['bottleneck']} "
                        f"t_bound={r['t_bound_s']:.4f}s "
                        f"useful={r['useful_flops_ratio']:.2f} "
                        f"kernels={rec['kernel_calls']}",
                        flush=True,
                    )
                except Exception as e:  # a cell failure is a bug; record it
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    path.write_text(json.dumps(rec, indent=1))
                    print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
    print(f"[dryrun] {len(archs) * len(shapes) * len(meshes)} cells in "
          f"{time.monotonic() - t_all:.1f}s, {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
