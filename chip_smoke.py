"""Chip smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for matmul and cuDNN;
  2. build: nvcc compiles the tile kernel from `src/repro_torch/.../csrc`;
  3. kernel vs plain: the CUDA tile kernel (`fused_tile_call`) against
     its plain PyTorch version (`matrix_tile_conv`) on the card, at every
     conv shape of the served nets, max rel err < 1e-5 (both fp32, with
     different summation orders);
  4. serve: `vgg_mixed_channel` and `fft_fewchannel` through `Engine` +
     `ConvServer` on the H100 hardware model, five requests cold and warm;
     every output finite, of the expected shape and within rel 1e-3 of
     the all-direct `run_direct` (cuDNN, TF32 off); the kernel's launch
     counter is zeroed before each net is served and must grow;
  5. times: kernel, plain and `F.conv2d` (library yardstick) per phase-3
     shape, median of CUDA-event-timed runs, beside the roofline bound;
     per-stage profile of a warm 64-bucket wave.

The line before the last is a JSON object listing the ported kernels; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX and
nothing of the reference package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
REL_TOL_KERNEL = 1e-5
REL_TOL_SERVE = 1e-3  # the reference's own net-level tolerance
SIZES = (64, 64, 32, 64, 32)  # the example's five requests
BUCKETS = (32, 64)
MAX_BATCH = 4
REPS = 25
KERNEL_SOURCE = "src/repro_torch/kernels/fused_tile/csrc/fused_tile.cu"
REPLACES = "src/repro/kernels/fused_tile/kernel.py:53"


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / (ref.abs().max() + 1e-30))


def time_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event-timed calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1 + 2


def phase_environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device {name}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels.fused_tile import kernel

    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"build: nvcc {' '.join(kernel.NVCC_FLAGS)} -> "
          f"{os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")


# ----------------------------------------------------------------- phase 3


def kernel_cases():
    """(label, transform, batch, h, w, c_in, c_out, groups, bias_relu, r)
    at the served nets' own conv shapes, plus a grouped and a
    ragged-width case.  R is what the planner gives each layer under
    the H100 model (lowered by `fit_r` exactly as the served path does)."""
    from repro_torch.configs.convnets import fft_fewchannel, vgg_mixed_channel
    from repro_torch.core import analysis, transforms, tune

    hw = analysis.H100_SXM
    wino = transforms.WinogradTransform(m=5, k=3)
    fft = transforms.FFTTransform(t=16, k=3)
    cases = []
    for bucket in (64, 32):
        h = bucket
        for layer in vgg_mixed_channel(3).layers:
            if layer.kind == "maxpool":
                h //= 2
            if layer.kind != "conv":
                continue
            r = tune.predict_r(layer.c_in, layer.c_out, transform=wino, hw=hw)
            cases.append((
                f"vgg b{bucket} {layer.c_in}->{layer.c_out}@{h}", wino,
                MAX_BATCH, h, h, layer.c_in, layer.c_out, 1, False, r,
            ))
    seen = set()
    for layer in fft_fewchannel(4).layers:
        key = (layer.c_in, layer.c_out)
        if layer.kind != "conv" or key in seen:
            continue
        seen.add(key)
        r = tune.predict_r(layer.c_in, layer.c_out, transform=fft, hw=hw)
        cases.append((
            f"fft b64 {layer.c_in}->{layer.c_out}@64 +bias+relu", fft,
            MAX_BATCH, 64, 64, layer.c_in, layer.c_out, 1, True, r,
        ))
    cases.append(("fft grouped g=2 8->8@32", fft, 2, 32, 32, 8, 8, 2, True, 8))
    cases.append(("wino ragged 5->7@37x29", wino, 3, 37, 29, 5, 7, 1, False, 8))
    return cases


def make_case(case, gen: np.random.Generator):
    """Device tensors for one case: the kernel's operands and the plain
    version's, built from one seeded draw."""
    from repro_torch.core import registry, tiling
    from repro_torch.kernels.fused_tile import kernel, matrix

    label, tr, b, h, w, c_in, c_out, groups, bias_relu, r = case
    dev = torch.device("cuda")
    spec = tr.kernel_spec()
    x = torch.tensor(gen.standard_normal((b, h, w, c_in)) * 0.1,
                     dtype=torch.float32, device=dev)
    wk = torch.tensor(gen.standard_normal((3, 3, c_in // groups, c_out)) * 0.1,
                      dtype=torch.float32, device=dev)
    bvec = torch.tensor(gen.standard_normal(c_out) * 0.1,
                        dtype=torch.float32, device=dev)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",))) if bias_relu else None
    plan = tiling.TilePlan.build(h, w, tr.k, 1, tr.t)
    r = kernel.fit_r(spec, min(r, plan.n_tiles_w), c_in, c_out)
    run_plan = matrix.pallas_block_geometry(plan, r) or plan
    rhs = spec.pack_rhs(tr.kernel_transform(wk), groups)
    if ep is not None:
        tags, biases = ep.kernel_form()
    else:
        tags, biases = (), torch.zeros((1, c_out), device=dev)
    return dict(
        label=label, spec=spec, plan=plan, run_plan=run_plan, r=r,
        groups=groups, ep=ep, tags=tags, biases=biases.contiguous(),
        x=x, wk=wk, bvec=bvec, rhs=rhs,
        xp_kernel=tiling.pad_input(x, run_plan).contiguous(),
        xp_plain=tiling.pad_input(x, plan),
    )


def run_kernel(c):
    from repro_torch.kernels.fused_tile import fused_tile_call

    y = fused_tile_call(
        c["xp_kernel"], c["rhs"], c["biases"], spec=c["spec"],
        n_tiles_h=c["run_plan"].n_tiles_h, n_tiles_w=c["run_plan"].n_tiles_w,
        r=c["r"], groups=c["groups"], ep_ops=c["tags"],
    )
    return y[:, : c["plan"].h_out, : c["plan"].w_out, :]


def run_plain(c):
    from repro_torch.kernels.fused_tile import matrix_tile_conv

    return matrix_tile_conv(
        c["xp_plain"], c["rhs"], c["plan"], c["spec"],
        groups=c["groups"], epilogue=c["ep"],
    )


def phase_kernel_vs_plain():
    gen = np.random.default_rng(0)
    made, worst_abs, worst_rel = [], 0.0, 0.0
    for case in kernel_cases():
        c = make_case(case, gen)
        y, ref = run_kernel(c), run_plain(c)
        torch.cuda.synchronize()
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise AssertionError(f"{c['label']}: bad kernel output {tuple(y.shape)}")
        err = rel_err(y, ref)
        abs_err = float((y - ref).abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, err)
        print(f"kernel-vs-plain {c['label']:34s} R={c['r']:2d} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e}")
        if not err < REL_TOL_KERNEL:
            raise AssertionError(
                f"{c['label']}: kernel vs plain rel err {err:.3e} >= {REL_TOL_KERNEL}"
            )
        made.append(c)
    return made, worst_abs, worst_rel


# ----------------------------------------------------------------- phase 4


def phase_serve():
    from repro_torch.configs.convnets import fft_fewchannel, vgg_mixed_channel
    from repro_torch.convserve import (
        ConvServeConfig, ConvServer, Engine, ImageRequest, init_weights,
        run_direct,
    )
    from repro_torch.core import analysis
    from repro_torch.kernels.fused_tile import kernel

    served = {}
    for spec in (vgg_mixed_channel(3), fft_fewchannel(4)):
        c_in = spec.conv_layers()[0][1].c_in
        engine = Engine(hw=analysis.H100_SXM, device="cuda")
        ws = init_weights(spec, seed=0)
        net = engine.compile(spec, ws, input_hw=(64, 64))
        srv = ConvServer(net, ConvServeConfig(max_batch=MAX_BATCH, buckets=BUCKETS))
        rng = np.random.default_rng(0)
        imgs = [rng.standard_normal((s, s, c_in)).astype(np.float32) * 0.1
                for s in SIZES]
        print(f"net {spec.name!r} on {engine.hw.name}:")
        print("  " + net.describe().replace("\n", "\n  "))
        print(f"  algorithms: {list(net.plan.algos())}")
        fused = [p.layer for p in net.plan.layers if p.algo in ("l3_fused", "fft_fused")]
        if not fused:
            print(f"  NOTE: {spec.name} plans no fused layer under {engine.hw.name}")

        kernel.LAUNCHES = 0  # main path: count only the served run
        t0 = time.perf_counter()
        out = srv.run([ImageRequest(i, im) for i, im in enumerate(imgs)])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches_cold = kernel.LAUNCHES
        waves_cold = srv.stats()["waves"]

        kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        out2 = srv.run([ImageRequest(10 + i, im) for i, im in enumerate(imgs)])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches_warm = kernel.LAUNCHES
        waves_warm = srv.stats()["waves"] - waves_cold

        worst = 0.0
        for i, im in enumerate(imgs):
            ref = run_direct(spec, ws, torch.from_numpy(im)[None].cuda())[0]
            want = spec.out_shape(*im.shape)
            for y in (out[i], out2[10 + i]):
                if tuple(y.shape) != want or not np.isfinite(y).all():
                    raise AssertionError(f"{spec.name} rid {i}: bad output {y.shape}")
                worst = max(worst, rel_err(torch.from_numpy(y).cuda(), ref))
        print(f"  served {len(out)}+{len(out2)} requests: cold {cold_s * 1e3:.1f} ms, "
              f"warm {warm_s * 1e3:.1f} ms; max rel err vs direct {worst:.3e}")
        print(f"  stats: {srv.stats()}")
        print(f"  tile-kernel launches: cold {launches_cold} over {waves_cold} waves, "
              f"warm {launches_warm} over {waves_warm} waves "
              f"({launches_warm / max(waves_warm, 1):.1f} per wave)")
        if not worst < REL_TOL_SERVE:
            raise AssertionError(f"{spec.name}: rel err {worst:.3e} >= {REL_TOL_SERVE}")
        if fused and launches_cold < 1:
            raise AssertionError(f"{spec.name}: plan has fused layers {fused} "
                                 "but the tile kernel never launched")
        served[spec.name] = dict(
            net=net, fused=fused, launches=launches_cold + launches_warm,
            per_wave=launches_warm / max(waves_warm, 1), c_in=c_in,
        )
    if sum(s["launches"] for s in served.values()) < 1:
        raise AssertionError("the tile kernel never launched on the served path")
    return served


# ----------------------------------------------------------------- phase 5


def bound(c) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for this
    call -- operations at the fp32 peak vs each input read and each
    output written once at the HBM rate."""
    spec, plan = c["spec"], c["plan"]
    b, _, _, c_in = c["x"].shape
    c_out = c["bvec"].shape[0]
    n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
    ops = 2 * spec.macs_per_tile(c_in, c_out, c["groups"]) * n_tiles
    n_bytes = 4 * (c["xp_kernel"].numel() + c["rhs"].numel()
                   + b * plan.h_out * plan.w_out * c_out)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(cases, served):
    import torch.nn.functional as F

    from repro_torch.convserve.planner import predict_stage_times

    rows = []
    for c in cases:
        x_nchw = c["x"].permute(0, 3, 1, 2).contiguous()
        w_oihw = c["wk"].permute(3, 2, 0, 1).contiguous()
        bias = c["bvec"] if c["ep"] is not None else None

        def library(x=x_nchw, w=w_oihw, bias=bias, g=c["groups"]):
            return F.conv2d(x, w, bias, padding=1, groups=g)

        k_ms = time_ms(lambda: run_kernel(c))
        p_ms = time_ms(lambda: run_plain(c))
        l_ms = time_ms(library)
        b_ms, b_by = bound(c)
        rows.append(dict(label=c["label"], ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"time {c['label']:34s} kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
              f"F.conv2d {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    gen = np.random.default_rng(1)
    for name, s in served.items():
        net = s["net"]
        x = torch.tensor(gen.standard_normal((MAX_BATCH, 64, 64, s["c_in"])) * 0.1,
                         dtype=torch.float32, device="cuda")
        predicted = dict(predict_stage_times(net.program, net.hw))
        print(f"profile_stages {name} (warm 64-bucket wave, batch {MAX_BATCH}):")
        for label, secs in net.profile_stages(x):
            print(f"  {label:14s} {secs * 1e3:8.3f} ms  (roofline model "
                  f"{predicted[label] * 1e3:.3f} ms)")
        print(f"  tile-kernel launches per warm wave: {s['per_wave']:.1f}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  -- fail before printing without the repo

    phase_environment()
    phase_build()
    cases, worst_abs, worst_rel = phase_kernel_vs_plain()
    served = phase_serve()
    rows = phase_times(cases, served)

    # headline shape: the widest served vgg layer when vgg reaches the
    # kernel (64->64 at bucket 64), else fft_fewchannel's 8->8
    vgg_fused = served["vgg-mixed"]["fused"]
    head_label = "vgg b64 64->64@64" if vgg_fused else "fft b64 8->8@64 +bias+relu"
    head = next(r for r in rows if r["label"] == head_label)
    kernels = {"kernels": [{
        "name": "fused_tile",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": sum(s["launches"] for s in served.values()),
        "launches_per_wave": {k: s["per_wave"] for k, s in served.items()},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "shape": head_label,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
