"""Time the CUDA tile kernel over its launch geometries at the served shapes.

    PYTHONPATH=src python -m repro_torch.kernels.fused_tile.sweep \
        [--out build/tile_sweep.json] [--reps 20] [--only LABEL]
    PYTHONPATH=src python -m repro_torch.kernels.fused_tile.sweep \
        --fit build/tile_sweep.json

Needs one CUDA card.  For each conv shape that `vgg_mixed_channel` and
`fft_fewchannel` send to the tile kernel (batch 4), every geometry that
`kernel.candidate_geometries` yields is launched, held against the plain
version (`matrix_tile_conv`, rel < 1e-5), and timed twice: the mean of
`reps` calls queued behind a spin so the card runs them back to back
(`device_ms`, what the cost model is fitted to), and the mean of `reps`
back-to-back calls between two CUDA events (`ms`, which includes the
wrapper's host path when that is the longer).  Each row
prints beside the cost model's estimate (`geometry_cost`) and the pick
of `launch_geometry` is marked, so the model can be checked against the
card.  Rows go to `--out` as JSON with the card's name and power limit.
`--fit` refits the model's weights to such a file, on any host.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

from repro_torch.core import tiling, transforms
from repro_torch.kernels.fused_tile import kernel, matrix

REL_TOL = 1e-5


def served_shapes():
    """(label, transform, batch, hw, c_in, c_out, bias_relu) of every tile
    kernel launch on the served ConvNet path, at batch 4."""
    wino = transforms.WinogradTransform(m=5, k=3)
    fft = transforms.FFTTransform(t=16, k=3)
    return [
        ("vgg 3->64@64", wino, 4, 64, 3, 64, False),
        ("vgg 64->64@64", wino, 4, 64, 64, 64, False),
        ("vgg 3->64@32", wino, 4, 32, 3, 64, False),
        ("vgg 64->64@32", wino, 4, 32, 64, 64, False),
        ("fft 4->8@64 +bias+relu", fft, 4, 64, 4, 8, True),
        ("fft 8->8@64 +bias+relu", fft, 4, 64, 8, 8, True),
    ]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean time of `reps` back-to-back calls between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def queued_ms(fn, reps: int) -> float:
    """Device time per call, ms: the stream first spins for about a
    millisecond (`torch.cuda._sleep`), long enough for the host to
    enqueue all `reps` calls, so the CUDA events around them time the
    kernels back to back and not the wrapper's host path."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep_shape(shape, reps: int, gen: np.random.Generator) -> list:
    from repro_torch.core import registry

    label, tr, b, hw, c_in, c_out, bias_relu = shape
    dev = torch.device("cuda")
    spec = tr.kernel_spec()
    plan = tiling.TilePlan.build(hw, hw, tr.k, 1, tr.t)
    x = torch.tensor(gen.standard_normal((b, hw, hw, c_in)) * 0.1,
                     dtype=torch.float32, device=dev)
    wk = torch.tensor(gen.standard_normal((3, 3, c_in, c_out)) * 0.1,
                      dtype=torch.float32, device=dev)
    bvec = torch.tensor(gen.standard_normal(c_out) * 0.1, dtype=torch.float32, device=dev)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",))) if bias_relu else None
    tags, biases = ep.kernel_form() if ep else ((), torch.zeros((1, c_out), device=dev))
    biases = biases.contiguous()
    rhs = spec.pack_rhs(tr.kernel_transform(wk), 1)
    xp = tiling.pad_input(x, plan).contiguous()
    ref = matrix.matrix_tile_conv(xp, rhs, plan, spec, epilogue=ep)
    n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
    r_max = kernel.fit_r(spec, 8, c_in, c_out)
    pick = kernel.launch_geometry(spec, n_tiles, c_in, c_out, 1, r_max)
    rows = []
    for geo in kernel.candidate_geometries(spec, n_tiles, c_in, c_out, 1, r_max):
        def run(geo=geo):
            return kernel.fused_tile_call(
                xp, rhs, biases, spec=spec, n_tiles_h=plan.n_tiles_h,
                n_tiles_w=plan.n_tiles_w, r=r_max, ep_ops=tags, geometry=geo,
            )

        y = run()[:, : plan.h_out, : plan.w_out]
        torch.cuda.synchronize()
        err = float((y - ref).abs().max() / (ref.abs().max() + 1e-30))
        if not err < REL_TOL:
            raise AssertionError(f"{label} {geo}: rel err {err:.3e} >= {REL_TOL}")
        rows.append(dict(
            shape=label, r=geo.r, ns=geo.ns, sc=geo.sc, n_split=geo.n_split,
            na=geo.na, stage_rhs=geo.stage_rhs, blocks=geo.blocks(n_tiles, c_out),
            smem=kernel.smem_bytes(spec, c_in, c_out, 1, geo),
            model=kernel.geometry_cost(spec, n_tiles, c_in, c_out, 1, geo),
            ms=events_ms(run, reps), device_ms=queued_ms(run, reps),
            rel_err=err, picked=geo == pick,
        ))
    return rows


def fit(path: str) -> tuple:
    """Refit `kernel._COST_THETA` to a sweep's JSON (no card needed):
    non-negative least squares of `device_ms` on `geometry_features`,
    weighted by 1/time.  Prints, per shape, the best measured geometry
    beside the one the refitted model would pick; returns theta."""
    from scipy.optimize import nnls

    shapes = {s[0]: s for s in served_shapes()}
    rows = json.loads(pathlib.Path(path).read_text())["rows"]
    feats, times = [], []
    for r in rows:
        _, tr, b, hw, c_in, c_out, _ = shapes[r["shape"]]
        spec = tr.kernel_spec()
        plan = tiling.TilePlan.build(hw, hw, tr.k, 1, tr.t)
        geo = kernel.Geometry(r=r["r"], ns=r["ns"], sc=r["sc"], n_split=r["n_split"],
                              na=r["na"], stage_rhs=r["stage_rhs"])
        feats.append(kernel.geometry_features(
            spec, b * plan.n_tiles_h * plan.n_tiles_w, c_in, c_out, 1, geo))
        times.append(r["device_ms"])
    x, y = np.array(feats), np.array(times)
    theta, _ = nnls(x / y[:, None], np.ones_like(y))
    pred = x @ theta
    print("theta", tuple(float(f"{t:.3g}") for t in theta))
    for label in shapes:
        idx = [i for i, r in enumerate(rows) if r["shape"] == label]
        if not idx:
            continue
        best = min(y[i] for i in idx)
        pick = y[min(idx, key=lambda i: pred[i])]
        err = np.median([abs(pred[i] - y[i]) / y[i] for i in idx])
        print(f"{label:24s} best {best:.4f} ms, model's pick {pick:.4f} ms "
              f"({pick / best:.2f}x), median model error {err:.0%}")
    return tuple(theta)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/tile_sweep.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="", help="substring of the shape labels to run")
    ap.add_argument("--fit", default="", help="refit the cost model to this sweep JSON and stop")
    args = ap.parse_args()
    if args.fit:
        fit(args.fit)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(f"card: {card}")
    gen = np.random.default_rng(0)
    everything = []
    for shape in served_shapes():
        if args.only and args.only not in shape[0]:
            continue
        rows = sweep_shape(shape, args.reps, gen)
        everything += rows
        best = min(rows, key=lambda r: r["device_ms"])
        pick = next(r for r in rows if r["picked"])
        by_model = sorted(rows, key=lambda r: r["model"])
        print(f"{shape[0]}: {len(rows)} geometries; best {best['device_ms']:.4f} ms "
              f"device at R{best['r']} ns{best['ns']} sc{best['sc']} split{best['n_split']} "
              f"staged {int(best['stage_rhs'])} ({best['blocks']} blocks); picked "
              f"{pick['device_ms']:.4f} ms device, {pick['ms']:.4f} ms events at R{pick['r']} "
              f"ns{pick['ns']} sc{pick['sc']} split{pick['n_split']} staged {int(pick['stage_rhs'])} "
              f"({pick['blocks']} blocks)")
        for r in sorted(rows, key=lambda r: r["device_ms"])[:12]:
            rank = by_model.index(r)
            print(f"   {r['device_ms']:.4f} ms device {r['ms']:.4f} events  R{r['r']} ns{r['ns']} sc{r['sc']} split{r['n_split']} "
                  f"na{r['na']} staged {int(r['stage_rhs'])} blocks {r['blocks']} smem {r['smem']} model rank {rank}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=everything)))
    print(f"wrote {len(everything)} rows to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
