"""Chip smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for matmul and cuDNN;
  2. build: the four kernels (`src/repro_torch/kernels/*/csrc/*.cu`),
     one nvcc each, started together, with build times;
  3. kernel vs plain: the CUDA tile kernel (`fused_tile_call`, at the
     geometry `launch_geometry` picks for each shape) against its plain
     PyTorch version (`matrix_tile_conv`) on the card, at every conv
     shape of the served nets, max rel err < 1e-5 (both fp32, with
     different summation orders);
  4. LM kernels vs plain: conv1d_fused, flash_attention and decode_mlp
     against `conv1d_ref`, `attention_ref` and `decode_mlp_ref` on the
     same card tensors, at the served shapes and at edge cases (ragged
     lengths, window on and off, GQA g=4 and g=1, non-causal, rows that
     see no key, decode B 1-11, a temporal `ConvSpec` through the
     registry), max rel err < 1e-5;
  5. serve ConvNets: `vgg_mixed_channel` and `fft_fewchannel` through
     `Engine` + `ConvServer` on the H100 hardware model, five requests
     cold and warm; every output finite, of the expected shape and within
     rel 1e-3 of the all-direct `run_direct` (cuDNN, TF32 off); the tile
     kernel's launch counter is zeroed before each net is served and must
     grow;
  6. serve LMs: gemma3-1b and mamba2-1.3b at full width and depth, fp32,
     random weights from seed 0, six requests (prompts 17..700 tokens) in
     waves of 4, 16 new tokens; prefill ms per wave, decode ms per step,
     tokens/s; every kernel count zeroed before each model and read
     after: flash launches = attention layers x waves, decode_mlp =
     MLP layers x decode steps, conv1d = mamba layers x waves;
  7. card vs CPU: each model's weights cut to one period of depth (6 / 4
     layers), one wave of two prompts (600 and 40 tokens) on the card and
     on the CPU through the port: prefill and teacher-forced decode logits
     within rel 1e-3, and equal greedy tokens;
  8. LM profile: one warm prefill of wave 1 and one decode step per
     model, host wall time beside `torch.profiler`'s device busy time,
     the idle share, and the top kernels by device time;
  9. times: kernel, plain and library yardstick per phase-3 and phase-4
     case (`F.conv2d`; `F.scaled_dot_product_attention` on kv heads
     repeated beforehand, with the boolean mask and, for causal cases
     without a window, also with `is_causal=True`; grouped `F.conv1d` with
     bias, SiLU outside it; none for the decode MLP), median of
     CUDA-event-timed runs, beside the bound (fp32 FMA peak; for flash,
     whose products run on the tensor cores, three TF32 products per
     FLOP at the TF32 peak, with the fp32 FMA bound beside it), and
     `torch.profiler`'s device time of the tile kernel at vgg 64->64 and
     fft 8->8, of flash at the served global layer and of the decode MLP
     at the served step; per-stage profile of a warm ConvNet 64-bucket
     wave.

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
PEAK_TF32 = 495e12  # H100 SXM TF32 tensor cores, dense (data sheet)
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


def kernel_libraries():
    """name -> (CudaLibrary, wrapper module) for every kernel of the port."""
    from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel
    from repro_torch.kernels.decode_mlp import kernel as mlp_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fused_tile import kernel as tile_kernel

    return {
        "fused_tile": tile_kernel,
        "conv1d_fused": conv1d_kernel,
        "flash_attention": flash_kernel,
        "decode_mlp": mlp_kernel,
    }


def phase_build() -> None:
    """Every kernel built from the checkout's sources, one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    def timed(mod):
        t0 = time.perf_counter()
        lib = mod.LIB.build()
        return lib, time.perf_counter() - t0

    mods = kernel_libraries()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(timed, mod) for name, mod in mods.items()}
        done = {name: f.result() for name, f in futs.items()}
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}")
    for name, (lib, secs) in done.items():
        print(f"  {name:16s} {os.path.relpath(mods[name].SOURCE, ROOT)} -> "
              f"{os.path.relpath(lib, ROOT)} in {secs:.2f} s")
    print(f"  all {len(done)} kernels built in {time.perf_counter() - t0:.2f} s")


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
    from repro_torch.kernels.fused_tile import kernel

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
    r = kernel.fit_r(spec, r, c_in, c_out)
    n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
    geo = kernel.launch_geometry(spec, n_tiles, c_in, c_out, groups, r)
    rhs = spec.pack_rhs(tr.kernel_transform(wk), groups)
    if ep is not None:
        tags, biases = ep.kernel_form()
    else:
        tags, biases = (), torch.zeros((1, c_out), device=dev)
    return dict(
        label=label, spec=spec, plan=plan, geo=geo, r=r,
        blocks=geo.blocks(n_tiles, c_out),
        groups=groups, ep=ep, tags=tags, biases=biases.contiguous(),
        x=x, wk=wk, bvec=bvec, rhs=rhs,
        xp=tiling.pad_input(x, plan).contiguous(),
    )


def run_kernel(c):
    from repro_torch.kernels.fused_tile import fused_tile_call

    y = fused_tile_call(
        c["xp"], c["rhs"], c["biases"], spec=c["spec"],
        n_tiles_h=c["plan"].n_tiles_h, n_tiles_w=c["plan"].n_tiles_w,
        r=c["r"], groups=c["groups"], ep_ops=c["tags"],
    )
    return y[:, : c["plan"].h_out, : c["plan"].w_out, :]


def run_plain(c):
    from repro_torch.kernels.fused_tile import matrix_tile_conv

    return matrix_tile_conv(
        c["xp"], c["rhs"], c["plan"], c["spec"],
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
        g = c["geo"]
        print(f"kernel-vs-plain {c['label']:34s} R={g.r} ns={g.ns} sc={g.sc} "
              f"split={g.n_split} blocks={c['blocks']} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e}")
        if not err < REL_TOL_KERNEL:
            raise AssertionError(
                f"{c['label']}: kernel vs plain rel err {err:.3e} >= {REL_TOL_KERNEL}"
            )
        made.append(c)
    return made, worst_abs, worst_rel


# ----------------------------------------------------------------- phase 5


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


# ----------------------------------------------------------------- phase 9


def bound(c) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for this
    call -- operations at the fp32 peak vs each input read and each
    output written once at the HBM rate."""
    spec, plan = c["spec"], c["plan"]
    b, _, _, c_in = c["x"].shape
    c_out = c["bvec"].shape[0]
    n_tiles = b * plan.n_tiles_h * plan.n_tiles_w
    ops = 2 * spec.macs_per_tile(c_in, c_out, c["groups"]) * n_tiles
    n_bytes = 4 * (c["xp"].numel() + c["rhs"].numel()
                   + b * plan.h_out * plan.w_out * c_out)
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# tile-kernel shapes whose device time phase 9 reads from the profiler
DEVICE_TIMED = ("vgg b64 64->64@64", "fft b64 8->8@64 +bias+relu")


def device_ms(fn, key: str, reps: int = 20):
    """Device time per call of the kernels whose names hold `key` that
    `fn` launches (with their second passes, e.g. a reduction), from
    `torch.profiler`'s device events over `reps` calls; None when the
    profiler saw no such event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_ms(e) for e in _kernel_events(prof) if key in e.key)
    return total / reps if total > 0 else None


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
        d_ms = device_ms(lambda: run_kernel(c), "tile_") if c["label"] in DEVICE_TIMED else None
        rows.append(dict(label=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        dev = "" if d_ms is None else f" (profiler device time {d_ms:.4f} ms)"
        print(f"time {c['label']:34s} kernel {k_ms:.4f} ms{dev}  plain {p_ms:.4f} ms  "
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


# ----------------------------------------------------------------- phase 4

# the LM path's served requests: prompt lengths (wave 1 = the first four,
# longer than gemma3's 512 window; its mamba2 prefill pads 700 -> 768)
LM_PROMPTS = (700, 17, 300, 520, 64, 129)
LM_NEW = 16
LM_MAX_LEN = 768
LM_ARCHS = ("gemma3-1b", "mamba2-1.3b")
DEV = "cuda"  # every LM phase runs its tensors here
LM_CUT = {"gemma3-1b": 6, "mamba2-1.3b": 4}  # one period of depth
REL_TOL_LM_KERNEL = 1e-5  # kernel vs plain, both fp32, other sum orders
REL_TOL_LM_CPU = 1e-3  # card vs CPU logits, the reference's net tolerance
LM_KERNELS = {
    "conv1d_fused": ("src/repro_torch/kernels/conv1d_fused/csrc/conv1d_fused.cu",
                     "src/repro/kernels/conv1d_fused/kernel.py:24"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:30"),
    "decode_mlp": ("src/repro_torch/kernels/decode_mlp/csrc/decode_mlp.cu",
                   "src/repro/kernels/decode_mlp/kernel.py:28"),
}


def _cuda(gen: np.random.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.tensor(gen.standard_normal(shape) * scale,
                        dtype=torch.float32, device=DEV)


def _bound(n_bytes: float, ops: float, peak: float = PEAK_FP32) -> tuple:
    t_ops, t_bytes = ops / peak * 1e3, n_bytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv1d_cases(gen):
    """One dict per case: kernel, label, served, run / plain / library
    callables (library None where no single PyTorch call exists), bound."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core import analysis, registry
    from repro_torch.kernels.conv1d_fused import conv1d_fused, conv1d_ref

    cfg = get_arch("mamba2-1.3b")
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    d_xbc = d_inner + 2 * s.n_groups * s.d_state  # 4352
    width = d_inner + d_xbc + d_inner // s.head_dim  # zxbcdt, 8512
    cases = []
    for label, b, length, d, k, row, act, served in (
        ("mamba2 wave1 B4 L768 D4352 (slice of 8512) silu", 4, 768, d_xbc, s.d_conv, width, "silu", True),
        ("mamba2 wave2 B2 L129 D4352 (slice of 8512) silu", 2, 129, d_xbc, s.d_conv, width, "silu", False),
        ("ragged L777 D100 K4 none", 2, 777, 100, 4, 100, "none", False),
        ("L5 < strip D64 K3 silu", 3, 5, 64, 3, 64, "silu", False),
    ):
        full = _cuda(gen, (b, length, row))
        x = full[..., d_inner:d_inner + d] if row > d else full
        w, bias = _cuda(gen, (k, d), 0.5), _cuda(gen, (d,), 0.1)
        xt = x.transpose(1, 2).contiguous()  # (B, D, L) for F.conv1d
        wt = w.t().contiguous()[:, None, :]  # (D, 1, K)

        def library(xt=xt, wt=wt, bias=bias, k=k, length=length):
            # grouped F.conv1d with bias; the SiLU would be a second call
            return F.conv1d(xt, wt, bias, padding=k - 1, groups=wt.shape[0])[..., :length]

        cases.append(dict(
            kernel="conv1d_fused", label=label, served=served,
            run=lambda x=x, w=w, bias=bias, act=act: conv1d_fused(x, w, bias, activation=act),
            plain=lambda x=x, w=w, bias=bias, act=act: conv1d_ref(x, w, bias, activation=act),
            library=library,
            bound=_bound(4 * (2 * b * length * d + k * d + d), 2 * k * b * length * d),
        ))
    # a temporal ConvSpec planned and executed through the registry
    spec = registry.ConvSpec(h=1, w=300, c_in=48, c_out=48, k=4, pad=3, groups=48)
    ap = registry.plan_conv(spec, analysis.H100_SXM)
    if ap.algo != "conv1d_fused":
        raise AssertionError(f"temporal spec planned {ap.algo}, not conv1d_fused")
    x4, w4 = _cuda(gen, (2, 1, 300, 48)), _cuda(gen, (1, 4, 1, 48), 0.5)
    zero = torch.zeros(48, device=DEV)
    alg = registry.get(ap.algo)
    cases.append(dict(
        kernel="conv1d_fused", label="registry temporal ConvSpec L300 D48 K4", served=False,
        run=lambda: alg.execute(x4, w4, None, ap),
        plain=lambda: conv1d_ref(x4[:, 0], w4[0, :, 0, :], zero, activation="none")[:, None],
        library=None,
        bound=_bound(4 * (2 * 2 * 300 * 48 + 5 * 48), 2 * 4 * 2 * 300 * 48),
    ))
    return cases


def flash_cases(gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    cases = []
    for label, b, hq, hkv, sq, sk, hd, causal, window, model_layout, served in (
        ("gemma3 wave1 global B4 S700 hd256 g4", 4, 4, 1, 700, 700, 256, True, 0, True, True),
        ("gemma3 wave1 local w512 B4 S700 hd256 g4", 4, 4, 1, 700, 700, 256, True, 512, True, False),
        ("gemma3 wave2 local w512 B2 S129 hd256 g4", 2, 4, 1, 129, 129, 256, True, 512, True, False),
        ("g=1 B2 H4 S100 hd64 causal", 2, 4, 4, 100, 100, 64, True, 0, False, False),
        ("non-causal Sq77 Sk256 hd128 g2", 1, 2, 1, 77, 256, 128, False, 0, False, False),
        ("causal w40 Sq50 Sk200 hd32 g4", 2, 8, 2, 50, 200, 32, True, 40, False, False),
        ("causal w8 S33 hd16 g4", 1, 4, 1, 33, 33, 16, True, 8, False, False),
        ("causal w40 Sq200 > Sk50 + w hd64 g2", 1, 2, 1, 200, 50, 64, True, 40, False, False),
    ):
        if model_layout:  # the model's (B, S, H, hd), viewed as (B, H, S, hd)
            q = _cuda(gen, (b, sq, hq, hd)).transpose(1, 2)
            k = _cuda(gen, (b, sk, hkv, hd)).transpose(1, 2)
            v = _cuda(gen, (b, sk, hkv, hd)).transpose(1, 2)
        else:
            q, k, v = (_cuda(gen, (b, hq, sq, hd)), _cuda(gen, (b, hkv, sk, hd)),
                       _cuda(gen, (b, hkv, sk, hd)))
        # the SDPA yardstick gets kv heads repeated before the timed call
        qc = q.contiguous()
        kr = k.repeat_interleave(hq // hkv, 1).contiguous()
        vr = v.repeat_interleave(hq // hkv, 1).contiguous()
        qp = torch.arange(sq, device=DEV)[:, None]
        kp = torch.arange(sk, device=DEV)[None, :]
        ok = torch.ones((sq, sk), dtype=torch.bool, device=DEV)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= qp - kp < window
        pairs = int(ok.sum())  # (q, key) pairs inside the band, per head

        def library(qc=qc, kr=kr, vr=vr, ok=ok):
            return F.scaled_dot_product_attention(qc, kr, vr, attn_mask=ok)

        def library_causal(qc=qc, kr=kr, vr=vr):
            # no mask tensor: SDPA may skip the upper triangle
            return F.scaled_dot_product_attention(qc, kr, vr, is_causal=True)

        ops = 4 * hd * pairs * b * hq
        cases.append(dict(
            kernel="flash_attention", label=label, served=served,
            run=lambda q=q, k=k, v=v, c=causal, w=window: flash_attention(q, k, v, causal=c, window=w),
            plain=lambda q=q, k=k, v=v, c=causal, w=window: attention_ref(q, k, v, causal=c, window=w),
            library=library,
            library_causal=library_causal if causal and not window and sq == sk else None,
            # the kernel's fp32-accurate products run on the tensor cores as
            # three TF32 products each (split operands): its bound is theirs;
            # the same FLOPs on the fp32 FMA units are the secondary bound
            bound=_bound(4 * (2 * q.numel() + k.numel() + v.numel()), 3 * ops, PEAK_TF32),
            bound_fp32_ms=_bound(4 * (2 * q.numel() + k.numel() + v.numel()), ops)[0],
            device_key="flash_fwd",
        ))
    return cases


def decode_mlp_cases(gen):
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_mlp import decode_mlp, decode_mlp_ref

    cfg = get_arch("gemma3-1b")
    cases = []
    for label, b, d, f, served in (
        (f"gemma3 decode B4 d{cfg.d_model} f{cfg.d_ff}", 4, cfg.d_model, cfg.d_ff, True),
        (f"gemma3 decode B2 d{cfg.d_model} f{cfg.d_ff}", 2, cfg.d_model, cfg.d_ff, False),
        (f"gemma3 decode B1 d{cfg.d_model} f{cfg.d_ff}", 1, cfg.d_model, cfg.d_ff, False),
        ("ragged B11 d200 f700", 11, 200, 700, False),
        ("B1 d64 f33", 1, 64, 33, False),
    ):
        x = _cuda(gen, (b, d))
        w1, w3 = _cuda(gen, (d, f), d ** -0.5), _cuda(gen, (d, f), d ** -0.5)
        w2 = _cuda(gen, (f, d), f ** -0.5)
        cases.append(dict(
            kernel="decode_mlp", label=label, served=served,
            run=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp(x, w1, w3, w2),
            plain=lambda x=x, w1=w1, w3=w3, w2=w2: decode_mlp_ref(x, w1, w3, w2),
            library=None,
            bound=_bound(4 * (3 * d * f + 2 * b * d), 2 * b * 3 * d * f),
            device_key="decode_mlp",
        ))
    return cases


def phase_lm_kernels_vs_plain():
    """Each LM kernel against its plain version on the card, on the same
    inputs, at the served shapes and at the edge cases."""
    gen = np.random.default_rng(0)
    cases = conv1d_cases(gen) + flash_cases(gen) + decode_mlp_cases(gen)
    worst = {}
    for c in cases:
        y, ref = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        if tuple(y.shape) != tuple(ref.shape) or not torch.isfinite(y).all():
            raise AssertionError(f"{c['label']}: bad kernel output {tuple(y.shape)}")
        abs_err = float((y - ref).abs().max())
        err = rel_err(y, ref)
        w = worst.setdefault(c["kernel"], [0.0, 0.0])
        w[0], w[1] = max(w[0], abs_err), max(w[1], err)
        print(f"kernel-vs-plain {c['kernel']:15s} {c['label']:48s} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e} "
              f"(tol rel {REL_TOL_LM_KERNEL:g})")
        if not err < REL_TOL_LM_KERNEL:
            raise AssertionError(
                f"{c['label']}: kernel vs plain rel err {err:.3e} >= {REL_TOL_LM_KERNEL}"
            )
    return cases, worst


# ------------------------------------------------------------ phase 6 - 8


def lm_requests(cfg, lengths, seed: int = 0):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=LM_NEW) for i, n in enumerate(lengths)]


def phase_serve_lm():
    """gemma3-1b and mamba2-1.3b at full published width and depth, fp32,
    random weights from seed 0: six requests, max_batch 4 (one full and
    one partial wave), 16 new tokens each.  Every kernel count is zeroed
    just before a model is served and read just after."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, ServeConfig

    mods = kernel_libraries()
    served = {}
    for name in LM_ARCHS:
        cfg = dataclasses.replace(get_arch(name), dtype="float32")
        t0 = time.perf_counter()
        model = init_lm(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{n_params / 1e9:.3f} B params fp32, init {time.perf_counter() - t0:.2f} s")
        reqs = lm_requests(cfg, LM_PROMPTS)
        engine = Engine(model, ServeConfig(max_batch=MAX_BATCH, max_len=LM_MAX_LEN))
        for mod in mods.values():
            mod.LAUNCHES = 0  # main path: count only the served run
        t0 = time.perf_counter()
        out = engine.run(reqs, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: mod.LAUNCHES for k, mod in mods.items()}
        for r in reqs:
            toks = out[r.rid]
            if len(toks) != LM_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"{name} rid {r.rid}: bad tokens {toks}")
        waves, steps = len(engine.waves), sum(w["decode_steps"] for w in engine.waves)
        n_tok = sum(w["tokens"] for w in engine.waves)
        for i, w in enumerate(engine.waves):
            print(f"  wave {i}: {w['size']} requests, prompt {w['prompt_len']} tokens, "
                  f"prefill {w['prefill_s'] * 1e3:.2f} ms, decode "
                  f"{w['decode_s'] / max(w['decode_steps'], 1) * 1e3:.3f} ms/step "
                  f"over {w['decode_steps']} steps")
        print(f"  {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
              f"({n_tok / wall:.1f} tokens/s, host clock after synchronize)")
        specs = model.specs
        want = {
            "fused_tile": 0,
            "flash_attention": sum(s.mixer == "attn" for s in specs) * waves,
            "decode_mlp": sum(s.has_mlp for s in specs) * steps,
            "conv1d_fused": sum(s.mixer == "mamba" for s in specs) * waves,
        }
        print(f"  launches: {launches} over {waves} waves, {steps} decode steps "
              f"(per prefill wave: flash {launches['flash_attention'] / waves:g}, "
              f"conv1d {launches['conv1d_fused'] / waves:g}; per decode step: "
              f"decode_mlp {launches['decode_mlp'] / steps:g})")
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"{name}: {k} launched {launches[k]} times, "
                                     f"expected {n} (layers x waves or steps)")
        served[name] = dict(model=model, cfg=cfg, launches=launches, waves=waves,
                            steps=steps)
    return served


def _cut(model, n_layers: int):
    """The same weights (shared, not copied), cut to the first
    `n_layers` layers."""
    import dataclasses

    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    tree = {k: model[k] for k in ("embed", "final_norm", "lm_head") if k in model}
    tree["layers"] = list(model.layers[:n_layers])
    return LM(cfg, tree)


def _logits_run(model, toks: np.ndarray, steps: int, forced=None):
    """Prefill `toks`, then `steps` decode steps fed greedily from this
    model's own logits, or teacher-forced on `forced`.  Returns the
    logits (steps + 1, B, V) on the host and the tokens fed."""
    from repro_torch.models import lm_decode_step, lm_prefill

    dev = model.device
    logits, state = lm_prefill(model, torch.from_numpy(toks).to(dev), LM_MAX_LEN)
    out, fed = [logits.float().cpu()], []
    for t in range(steps):
        cur = forced[t] if forced is not None else out[-1].argmax(-1).numpy()
        fed.append(cur)
        logits, state = lm_decode_step(
            model, torch.from_numpy(np.asarray(cur, np.int64)).to(dev),
            toks.shape[1] + t, state)
        out.append(logits.float().cpu())
    return torch.stack(out), fed


def phase_lm_vs_cpu(served):
    """The served weights cut to one period of depth, one wave of two
    requests (one longer than the 512 window), on the card and on the CPU
    through the port: prefill and teacher-forced decode logits within
    REL_TOL_LM_CPU, and the same greedy tokens."""
    import copy

    for name, s in served.items():
        cut = _cut(s["model"], LM_CUT[name])
        cpu = copy.deepcopy(cut).to("cpu")
        reqs = lm_requests(s["cfg"], (600, 40), seed=1)
        toks = np.zeros((2, 600), np.int64)
        for i, r in enumerate(reqs):
            toks[i, 600 - len(r.prompt):] = r.prompt
        t0 = time.perf_counter()
        card, fed = _logits_run(cut, toks, LM_NEW)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, _ = _logits_run(cpu, toks, LM_NEW, forced=fed)
        t_cpu = time.perf_counter() - t0
        if not (torch.isfinite(card).all() and torch.isfinite(host).all()):
            raise AssertionError(f"{name}: non-finite logits")
        scale = float(host.abs().max())
        errs = [float((card[i] - host[i]).abs().max()) / scale for i in range(len(card))]
        top2 = card.topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        same = bool((card.argmax(-1) == host.argmax(-1)).all())
        print(f"card-vs-cpu {name} cut to {LM_CUT[name]} layers, prompts (600, 40): "
              f"prefill rel err {errs[0]:.3e}, decode max rel err {max(errs[1:]):.3e} "
              f"(tol {REL_TOL_LM_CPU:g}); greedy tokens equal: {same} "
              f"(smallest top-2 logit margin {margin:.3e}); card {t_card:.2f} s, "
              f"cpu {t_cpu:.2f} s")
        if not max(errs) < REL_TOL_LM_CPU:
            raise AssertionError(f"{name}: card vs cpu rel err {max(errs):.3e}")
        if not same:
            raise AssertionError(f"{name}: greedy tokens differ between card and cpu")


def _kernel_events(prof) -> list:
    """The profiler's device-side events (kernels, copies, memsets),
    averaged by name.  Host-side operator events also carry the device
    time of the kernels they launched, so summing them too would count
    each kernel twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _device_ms(event) -> float:
    """An averaged device event's total time, ms."""
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0)
    return us / 1e3


def phase_lm_profile(served):
    """Where a wave's time goes: one warm prefill of wave 1's four prompts
    and one decode step after it, per model.  Wall time on the host clock
    (after synchronize, without the profiler), device busy time summed
    over `torch.profiler`'s device events, the idle share between them,
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm_decode_step, lm_prefill

    for name, s in served.items():
        model, cfg = s["model"], s["cfg"]
        reqs = lm_requests(cfg, LM_PROMPTS[:MAX_BATCH])
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt
        toks = torch.from_numpy(toks).to(DEV)
        _, state = lm_prefill(model, toks, LM_MAX_LEN)
        tok = toks[:, -1]
        calls = {
            f"prefill B{len(reqs)} S{plen}": lambda: lm_prefill(model, toks, LM_MAX_LEN),
            f"decode step B{len(reqs)}": lambda: lm_decode_step(model, tok, plen, state),
        }
        for label, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = _kernel_events(prof)
            busy = sum(_device_ms(e) for e in events)
            if busy <= 0:
                print(f"profile {name} {label}: wall {wall:.3f} ms; device time not "
                      "measured (the profiler saw no device events)")
                continue
            print(f"profile {name} {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
                  f"in {sum(e.count for e in events)} device events, "
                  f"idle share {max(0.0, 1 - busy / wall):.3f}")
            for e in sorted(events, key=_device_ms, reverse=True)[:8]:
                print(f"  {_device_ms(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_lm_times(cases):
    """Kernel, plain and library times at every LM case (median of CUDA
    events), beside the bound; at the served flash and decode-MLP shapes
    also `torch.profiler`'s device time, and for causal flash cases with
    no window SDPA with `is_causal=True` beside the masked call.  The
    served shape's row goes into the kernels line."""
    rows = {}
    for c in cases:
        k_ms = time_ms(c["run"])
        p_ms = time_ms(c["plain"])
        l_ms = time_ms(c["library"]) if c["library"] is not None else None
        lc_ms = time_ms(c["library_causal"]) if c.get("library_causal") else None
        d_ms = device_ms(c["run"], c["device_key"]) if c["served"] and "device_key" in c else None
        b_ms, b_by = c["bound"]
        lib = f"{l_ms:.4f} ms" if l_ms is not None else "-"
        extra = "" if d_ms is None else f" (profiler device time {d_ms:.4f} ms)"
        if lc_ms is not None:
            lib += f", is_causal {lc_ms:.4f} ms"
        fp32 = c.get("bound_fp32_ms")
        bounds = f"bound {b_ms:.4f} ms ({b_by}"
        bounds += ")" if fp32 is None else (
            f", split-TF32 tensor cores), fp32 FMA bound {fp32:.4f} ms")
        print(f"time {c['kernel']:15s} {c['label']:48s} kernel {k_ms:.4f} ms{extra}  "
              f"plain {p_ms:.4f} ms  library {lib}  {bounds}")
        if c["served"]:
            row = dict(shape=c["label"], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
            if c["kernel"] == "flash_attention":
                row.update(library_is_causal_ms=lc_ms, bound_fp32_ms=fp32)
            rows[c["kernel"]] = row
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
    lm_cases, lm_worst = phase_lm_kernels_vs_plain()
    served = phase_serve()
    lm_served = phase_serve_lm()
    phase_lm_vs_cpu(lm_served)
    phase_lm_profile(lm_served)
    rows = phase_times(cases, served)
    lm_rows = phase_lm_times(lm_cases)

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
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]}
    for name, (source, replaces) in LM_KERNELS.items():
        arch = "mamba2-1.3b" if name == "conv1d_fused" else "gemma3-1b"
        run = lm_served[arch]
        per = run["steps"] if name == "decode_mlp" else run["waves"]
        kernels["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=run["launches"][name],
            launches_per=(f"{run['launches'][name] / per:g} per "
                          f"{'decode step' if name == 'decode_mlp' else 'prefill wave'} "
                          f"of {arch}"),
            max_abs_err=lm_worst[name][0], max_rel_err=lm_worst[name][1],
            **lm_rows[name],
        ))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
