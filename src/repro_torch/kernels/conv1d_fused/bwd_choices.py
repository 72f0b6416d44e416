"""The bf16 conv1d backward's design choices, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.conv1d_fused.bwd_choices \
        [--reps 20] [--seeds 0 1 2] [--out build/bwd_choices.json]

Three parts, each against the committed kernel (`csrc/conv1d_fused_bwd_bf16.cu`
through `backward.conv1d_fused_bwd_call`):

- Times.  The committed kernel and each choice in `CHOICES`, one changed at
  a time, at mamba2-1.3b's and zamba2-7b's training slices, in two rounds
  (the second in reverse order): the profiler's device time a call (mean
  over `reps`) and CUDA events (median of `reps`).  A choice is a source
  variant, the committed source with a few lines replaced, built beside it
  under `build/bwd_choices/`; the geometry choice also launches with its
  own blocks a slab and ring stages.  Every variant's dx must be bitwise
  the committed kernel's (each keeps an element's chain), and its dw and
  db too, except where the choice regroups their sums (other blocks, or
  a partial set a segment).
- Sums.  dx, dw and db of the committed kernel (one partial row set a
  block over its whole range, the second kernel summing a slab's sets in
  block order) and of the segment-walk kernel's grouping (`SEGMENT_SUMS`:
  a set a 32-row segment, summed in segment order; the sums of the earlier
  kernel, bit for bit) against float64 from the same bf16 inputs, beside
  the plain version's (`ref.conv1d_bwd_ref`), by the bf16 rule of the
  card tests: the kernel's max error at most twice the plain version's
  plus one bf16 ulp of the gradient's max.
- Training.  mamba2-1.3b, bf16, 48 layers, 6 steps of 4 x 1024 tokens
  through `launch.train.main`, as `chip_smoke.py`'s phase 18 trains it, at
  each of `--seeds` (weights and data), with the committed kernel, with the
  segment sums, and (seed 0) with the committed kernel's dw moved one
  bf16 ulp away from zero in every element of every call: each run's
  losses a step, batch 0's loss after the steps against step 0's, and
  the mean loss over the six batches after the steps against at init
  (phase 18's check).

Rows go to `--out` with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.bitwise_check import _device_ms, _event_ms
from repro_torch.kernels.conv1d_fused import backward
from repro_torch.kernels.conv1d_fused.ref import conv1d_bwd_ref

HEADER = pathlib.Path(__file__).parents[1] / "flash_attention" / "csrc" / "hopper.cuh"
STREAM = pathlib.Path(__file__).parent / "csrc" / "stream.cuh"  # the streams' shared part
VARIANTS = _build.BUILD_DIR.parent / "bwd_choices"
# one partial row set a 32-row segment, summed in segment order by the
# second kernel (batch x segments sets of scratch: `segment_scratch`)
SEGMENT_SUMS = (
    ("      if (H == 0) store_dx(m_run + m, p.b, j * kChunk);\n",
     "      if (H == 0) store_dx(m_run + m, p.b, j * kChunk);\n"
     "      if ((j & 1) || j + 1 == chunks) {\n"
     "        if (active) write_partial(part + ((size_t)(p.b * a.segs + j / 2) * (K + 1)) * a.d + c);\n"
     "        for (int v = 0; v < kVec; ++v) {\n"
     "          for (int i = 0; i < K; ++i) dws[i][v] = 0.f;\n"
     "          dbs[v] = 0.f;\n"
     "        }\n"
     "      }\n"),
    ("  if (active) write_partial(part + ((size_t)kb * (K + 1)) * a.d + c);\n", ""),
    ("return launch_reduce(part, dw, db, a.per_slab, a, s);",
     "return launch_reduce(part, dw, db, a.batch * a.segs, a, s);"),
)
# name -> (source lines replaced, (blocks an SM, ring stages) or None, dw / db
# regrouped: other blocks, or sets a segment)
CHOICES = {
    "2 channels a thread": ((("constexpr int kVec = 1;", "constexpr int kVec = 2;"),), None,
                            False),
    "2 blocks an SM, 3 stages": ((("__launch_bounds__(kThreads, 3)",
                                   "__launch_bounds__(kThreads, 2)"),), (2, 3), True),
    "L2 promotion 128 B": ((("kPromotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                             "kPromotion = CU_TENSOR_MAP_L2_PROMOTION_L2_128B"),), None, False),
    "sums a 32-row segment": (SEGMENT_SUMS, None, True),
}
# (label, (B, L, row stride, column, D, K)): the xBC slices of zxbcdt
SHAPES = (("mamba2 train B4 L1024 D4352", (4, 1024, 8512, 4096, 4352, 4)),
          ("zamba2 train B4 L1024 D7296", (4, 1024, 14576, 7168, 7296, 4)))
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "mamba2-1.3b", 6, 4, 1024


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def variant(name: str, lines: tuple, lib: _build.CudaLibrary = None,
            out_dir: pathlib.Path = VARIANTS) -> _build.CudaLibrary:
    """`lib`'s committed bf16 source (default the backward's) with the
    streams' shared `stream.cuh` written into it, then each `lines` pair's
    first text (found exactly once) replaced by its second, as a library
    of its own under `out_dir` (`hopper.cuh` included by its absolute
    path)."""
    lib = backward.LIB_BF16 if lib is None else lib
    shared = STREAM.read_text().replace("#pragma once\n", "")
    text = lib.source.read_text().replace('#include "stream.cuh"', shared)
    for old, new in lines:
        if text.count(old) != 1:
            raise ValueError(f"{lib.source.name} holds {old!r} {text.count(old)} times")
        text = text.replace(old, new)
    text = text.replace('"../../flash_attention/csrc/hopper.cuh"', f'"{HEADER.resolve()}"')
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.cu"
    path.write_text(text)
    return _build.CudaLibrary(path, name, lib.entry_points)


@contextlib.contextmanager
def using(lib, segments: bool = False):
    """`backward`'s bf16 library swapped for `lib` (None: the committed
    one), and with `segments` its scratch sized for a partial row set a
    segment (`SEGMENT_SUMS`), put back after."""
    saved, saved_part = backward.LIB_BF16, backward.Bf16Geometry.part_floats
    if lib is not None:
        backward.LIB_BF16 = lib
    if segments:
        backward.Bf16Geometry.part_floats = (
            lambda geo, k, d: geo.batch * geo.segs * (k + 1) * d)
    try:
        yield
    finally:
        backward.LIB_BF16, backward.Bf16Geometry.part_floats = saved, saved_part


def launch_with(lib, x, w, b, g, blocks_per_sm: int, stages: int):
    """(dx, dw, db) from `lib` at `blocks_per_sm` blocks an SM and
    `stages` ring stages (x, w, b, g as the TMA copies take them)."""
    bsz, length, d = x.shape
    k = w.shape[0]
    sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = backward.bf16_geometry(bsz, length, d, sm)
    per_slab = max(1, min(bsz * geo.segs, blocks_per_sm * sm // geo.n_slabs))
    args = backward.BwdBf16Args(x.stride(1), bsz, length, d, k, 1, geo.n_slabs, per_slab,
                                geo.segs, stages, backward.stream_smem_bytes(stages),
                                0, 0, 0, 0)
    dx = torch.empty((bsz, length, d), dtype=x.dtype, device=x.device)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    part = torch.empty(per_slab * (k + 1) * d, dtype=torch.float32, device=x.device)
    lib.launch(backward.ENTRY[torch.bfloat16], x.device, x.data_ptr(), w.data_ptr(),
               b.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
               part.data_ptr(), ctypes.addressof(args))
    return dx, dw, db


def _bf16(gen, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.tensor(gen.standard_normal(shape) * scale, dtype=torch.float32,
                        device="cuda").bfloat16()


def _data(gen):
    out = []
    for label, (b, length, row, col, d, k) in SHAPES:
        x = _bf16(gen, (b, length, row))[..., col:col + d]
        out.append((label, x, _bf16(gen, (k, d), 0.5), _bf16(gen, (d,), 0.1),
                    _bf16(gen, (b, length, d))))
    return out


def _f64(x, w, b, g):
    """dx, dw, db of silu(causal depthwise conv + b) in float64 from the
    bf16 inputs."""
    k, length = w.shape[0], x.shape[1]
    x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, w, b))
    xp = F.pad(x64, (0, 0, k - 1, 0))
    y = F.silu(sum(xp[:, i:i + length] * w64[i] for i in range(k)) + b64)
    return torch.autograd.grad(y, (x64, w64, b64), g.double())


def _ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(v, 2.0 ** -126))) - 7)


def times(libs: dict, data: list, reps: int) -> list:
    """Each choice's device and event times, its outputs against the
    committed kernel's."""
    want = {label: backward.conv1d_fused_bwd_call(x, w, b, g, activation="silu")
            for label, x, w, b, g in data}
    rows = []
    order = ["committed"] + list(CHOICES)
    for rnd in range(2):
        for name in order if rnd == 0 else order[::-1]:
            lib, geom, regrouped = libs[name]
            for label, x, w, b, g in data:
                if geom is None:
                    def run(x=x, w=w, b=b, g=g):
                        return backward.conv1d_fused_bwd_call(x, w, b, g, activation="silu")
                else:
                    def run(x=x, w=w, b=b, g=g, lib=lib, geom=geom):
                        return launch_with(lib, x, w, b, g, *geom)
                with using(lib if geom is None else None, regrouped):
                    got = run()
                    same = [bool(torch.equal(a, c)) for a, c in zip(got, want[label])]
                    ev, dev = _event_ms(run, reps), _device_ms(run, "conv1d_bwd", reps)
                rows.append(dict(part="times", choice=name, shape=label, round=rnd, ms=ev,
                                 device_ms=dev, dx_dw_db_bitwise_committed=same))
                print(f"round {rnd} {name:26s} {label:30s} events {ev:.4f} ms device "
                      f"{'none' if dev is None else f'{dev:.4f}'} ms; dx / dw / db bitwise "
                      f"the committed kernel's {' / '.join(map(str, same))}")
                if not same[0] or (not regrouped and not all(same)):
                    raise AssertionError(f"{name} changes what it must keep at {label}")
    return rows


def sums(lib, data: list) -> list:
    """The committed kernel's and the segment sums' errors against
    float64, beside the plain version's, by the bf16 rule."""
    rows = []
    for label, x, w, b, g in data:
        e64 = _f64(x, w, b, g)
        plain = conv1d_bwd_ref(g, x, w, b)
        for name, lib_ in (("committed", None), ("sums a 32-row segment", lib)):
            with using(lib_, lib_ is not None):
                got = backward.conv1d_fused_bwd_call(x, w, b, g, activation="silu")
                again = backward.conv1d_fused_bwd_call(x, w, b, g, activation="silu")
            for what, a, p, e in zip(("dx", "dw", "db"), got, plain, e64):
                err_k = float((a.double() - e).abs().max())
                err_p = float((p.double() - e).abs().max())
                ulp = _ulp(float(e.abs().max()))
                ok = err_k <= 2 * err_p + ulp
                rows.append(dict(part="sums", choice=name, shape=label, grad=what,
                                 err_kernel=err_k, err_plain=err_p, limit=2 * err_p + ulp,
                                 within=ok, bitwise_twice=all(
                                     torch.equal(u, v) for u, v in zip(got, again))))
                print(f"sums {name:21s} {label:30s} {what}: err vs f64 {err_k:.4e}, plain "
                      f"{err_p:.4e}, limit {2 * err_p + ulp:.4e} (2x plain + 1 ulp): "
                      f"{'within' if ok else 'OUTSIDE'}")
        del e64, plain
    return rows


@contextlib.contextmanager
def dw_one_ulp_up():
    """Every bf16 call's dw moved one ulp away from zero (its bits + 1)."""
    call = backward.conv1d_fused_bwd_call

    def moved(x, w, b, g, *, activation):
        dx, dw, db = call(x, w, b, g, activation=activation)
        if dw.dtype == torch.bfloat16:
            dw = (dw.view(torch.int16) + 1).view(torch.bfloat16)
        return dx, dw, db
    backward.conv1d_fused_bwd_call = moved
    try:
        yield
    finally:
        backward.conv1d_fused_bwd_call = call


def training(lib, seeds: list) -> list:
    """mamba2-1.3b's bf16 training as phase 18 runs it, per seed and
    kernel: the losses a step, batch 0's after against step 0's, and the
    six batches' mean after against at init."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.models.common import f32_accumulation

    cfg = get_arch(TRAIN_ARCH)

    def losses(model, batches):
        out = []
        with torch.no_grad(), f32_accumulation():
            for bt in batches:
                out.append(float(lm_loss(model, bt)[0]))
        return out

    rows = []
    for seed in seeds:
        stream = TokenStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed))
        batches = [{k: torch.as_tensor(v).to("cuda", dtype=torch.long if k in (
            "tokens", "targets") else None) for k, v in stream.batch_at(i).items()}
            for i in range(TRAIN_STEPS)]
        model = init_lm(cfg, seed=seed, device="cuda")
        at_init = losses(model, batches)
        del model
        torch.cuda.empty_cache()
        runs = [("committed", None, contextlib.nullcontext)]
        runs.append(("sums a 32-row segment", lib, contextlib.nullcontext))
        if seed == seeds[0]:
            runs.append(("committed, dw one ulp up", None, dw_one_ulp_up))
        for name, lib_, ctx in runs:
            with using(lib_, lib_ is not None), ctx():
                state, hist = launch_train.main([
                    "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
                    str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", str(seed)])
            after = losses(state["params"], batches)
            del state
            torch.cuda.empty_cache()
            step_losses = [h["loss"] for h in hist]
            falls0 = math.isfinite(after[0]) and after[0] < step_losses[0]
            rows.append(dict(part="training", seed=seed, kernel=name, step_losses=step_losses,
                             batch0_at_step0=step_losses[0], batch0_after=after[0],
                             batch0_falls=falls0, mean_at_init=float(np.mean(at_init)),
                             mean_after=float(np.mean(after)), losses_at_init=at_init,
                             losses_after=after))
            print(f"training seed {seed} {name:26s}: step losses "
                  f"{' '.join(f'{v:.4f}' for v in step_losses)}; batch 0 {step_losses[0]:.6f} "
                  f"-> {after[0]:.6f} ({'falls' if falls0 else 'DOES NOT FALL'}); six "
                  f"batches' mean {np.mean(at_init):.6f} at init -> {np.mean(after):.6f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_choices: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}")
    libs = {"committed": (None, None, False)}
    for i, (name, (lines, geom, regrouped)) in enumerate(CHOICES.items()):
        libs[name] = (variant(f"conv1d_fused_bwd_bf16_choice{i}", lines), geom, regrouped)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(),
                      [backward.LIB_BF16] + [v[0] for v in libs.values() if v[0] is not None]))
    data = _data(np.random.default_rng(6))
    rows = times(libs, data, args.reps)
    rows += sums(libs["sums a 32-row segment"][0], data)
    del data
    torch.cuda.empty_cache()
    rows += training(libs["sums a 32-row segment"][0], args.seeds)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
