"""The bf16 conv1d forward stream's design choices, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.conv1d_fused.fwd_choices \
        [--reps 20] [--out build/fwd_choices.json]

The committed stream (`csrc/conv1d_fused_fwd_bf16.cu`, as
`kernel.conv1d_fused_call` launches it) and each choice in `CHOICES`, one
changed at a time, at mamba2-1.3b's and zamba2-7b's first prefill waves,
mamba2's second wave and its training slice, in two rounds (the second in
reverse order): the profiler's device time a call (mean over `reps`) and
CUDA events (median of `reps`).  A choice is a launch geometry (blocks an
SM, ring stages) and, where it needs one, a source variant: the committed
source with a few lines replaced, built beside it under
`build/fwd_choices/` (`bwd_choices.variant`).  Every choice's output must
be bitwise the committed kernel's: each keeps an element's chain.  Beside them two yardsticks at the same shapes: the
committed kernel without the SiLU (activation "none": the chain's expf
and divide gone, the bytes the same) and `copy_` of the same x slice into
a contiguous tensor (one read and one write of the kernel's bytes, by
PyTorch's copy kernel).  Rows go to `--out` with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitwise_check import _device_ms, _event_ms
from repro_torch.kernels.conv1d_fused import bwd_choices
from repro_torch.kernels.conv1d_fused import kernel
from repro_torch.kernels.conv1d_fused.compare import HBM_BW

VARIANTS = _build.BUILD_DIR.parent / "fwd_choices"
# the design before per-warp stores: the block meets at a named barrier
# after every chunk and one thread stores the chunk, 4 boxes of 64 channels
BLOCK_STORES = (
    ('''  auto store_y = [&](int m_abs, int b, int row0) {
    hopper::fence_async();
    __syncwarp();
    if (lane == 0) {
      hopper::tma_store3(&my, out_buffer(m_abs), c0 + kWarpCh * warp, row0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<kOutBuffers - 1>();
    }
    __syncwarp();
  };''', '''  auto store_y = [&](int m_abs, int b, int row0) {
    hopper::fence_async();
    if (tid == 0) hopper::bulk_wait_read<kOutBuffers - 2>();
    hopper::bar(1, kConsumers);
    if (tid == 0) {
      const uint32_t src = yb + (m_abs % kOutBuffers) * kRowsBytes;
#pragma unroll
      for (int bx = 0; bx < 4; ++bx)
        hopper::tma_store3(&my, src + bx * (kChunk * 128), c0 + 64 * bx, row0, b);
      hopper::bulk_commit();
    }
  };'''),
    ("      Word* out = reinterpret_cast<Word*>(smem + (out_buffer(m_abs) - ring)) + lane;",
     "      Word* out = word(yb + (m_abs % kOutBuffers) * kRowsBytes, kChunk);"),
    ("        out[r * 32] = L::pack(o);  // a row of the warp's box: 32 words",
     "        out[r * kRowWords] = L::pack(o);"),
    ("  if (lane == 0) hopper::bulk_wait_all();\n}", "  if (tid == 0) hopper::bulk_wait_all();\n}"),
    ("  const uint32_t box_y[3] = {kWarpCh, kChunk, 1};",
     "  const uint32_t box_y[3] = {64, kChunk, 1};"),
)
# name -> (source lines replaced, or () for the committed source; blocks an
# SM, ring stages)
CHOICES = {
    "2 channels a thread": ((("constexpr int kVec = 1;", "constexpr int kVec = 2;"),),
                            kernel.BLOCKS_PER_SM, kernel.STREAM_STAGES),
    "2 ring stages": ((), kernel.BLOCKS_PER_SM, 2),
    "4 blocks an SM, 2 stages": (
        (("constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 4;"),), 4, 2),
    "block-wide stores": (BLOCK_STORES, kernel.BLOCKS_PER_SM, kernel.STREAM_STAGES),
}
# (label, (B, L, row stride, column, D, K)): the xBC slices of zxbcdt
SHAPES = (("mamba2 wave1 B4 L768 D4352", (4, 768, 8512, 4096, 4352, 4)),
          ("zamba2 wave1 B4 L768 D7296", (4, 768, 14576, 7168, 7296, 4)),
          ("mamba2 wave2 B2 L129 D4352", (2, 129, 8512, 4096, 4352, 4)),
          ("mamba2 train B4 L1024 D4352", (4, 1024, 8512, 4096, 4352, 4)))


def launch_with(lib, x, w, b, blocks_per_sm: int, stages: int):
    """SiLU(conv) from `lib` at `blocks_per_sm` blocks an SM and `stages`
    ring stages."""
    bsz, length, d = x.shape
    sm = kernel.sm_count(x.get_device())
    n_slabs, _, segs = kernel.slab_split(bsz, length, d, sm)
    per_slab = max(1, min(bsz * segs, blocks_per_sm * sm // n_slabs))
    args = kernel.FwdBf16Args(x.stride(1), bsz, length, d, w.shape[0], 1, n_slabs, per_slab,
                              segs, stages, kernel.fwd_smem_bytes(stages))
    out = torch.empty((bsz, length, d), dtype=x.dtype, device=x.device)
    lib.launch(kernel.STREAM_ENTRY, x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
               out.data_ptr(), ctypes.addressof(args))
    return out


def _bf16(gen, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.tensor(gen.standard_normal(shape) * scale, dtype=torch.float32,
                        device="cuda").bfloat16()


def times(libs: dict, reps: int) -> list:
    """Each choice's device and event times, its output against the
    committed kernel's."""
    gen = np.random.default_rng(7)
    data = []
    for label, (b, length, row, col, d, k) in SHAPES:
        x = _bf16(gen, (b, length, row))[..., col:col + d]
        data.append((label, x, _bf16(gen, (k, d), 0.5), _bf16(gen, (d,), 0.1)))
    want = {label: kernel.conv1d_fused_call(x, w, b, activation="silu")
            for label, x, w, b in data}
    rows = []
    order = ["committed"] + list(CHOICES)
    for rnd in range(2):
        for name in order if rnd == 0 else order[::-1]:
            lib, geom = libs[name]
            for label, x, w, b in data:
                if geom is None:
                    def run(x=x, w=w, b=b):
                        return kernel.conv1d_fused_call(x, w, b, activation="silu")
                else:
                    def run(x=x, w=w, b=b, lib=lib, geom=geom):
                        return launch_with(lib, x, w, b, *geom)
                same = bool(torch.equal(run(), want[label]))
                ev, dev = _event_ms(run, reps), _device_ms(run, "conv1d_fwd_bf16", reps)
                rows.append(dict(choice=name, shape=label, round=rnd, ms=ev, device_ms=dev,
                                 bitwise_committed=same))
                print(f"round {rnd} {name:26s} {label:30s} events {ev:.4f} ms device "
                      f"{'none' if dev is None else f'{dev:.4f}'} ms; bitwise the committed "
                      f"kernel's {same}")
                if not same:
                    raise AssertionError(f"{name} changes the output at {label}")
    return rows


def yardsticks(reps: int) -> list:
    """Device time a call of the committed kernel without the SiLU and of
    `copy_` of the x slice, at every shape, beside the bound."""
    gen = np.random.default_rng(9)
    rows = []
    for label, (b, length, row, col, d, k) in SHAPES:
        x = _bf16(gen, (b, length, row))[..., col:col + d]
        w, bias = _bf16(gen, (k, d), 0.5), _bf16(gen, (d,), 0.1)
        out = torch.empty((b, length, d), dtype=x.dtype, device=x.device)
        bound = 2 * b * length * d * 2 / HBM_BW * 1e3
        for what, run, key in (
                ("committed, SiLU", lambda: kernel.conv1d_fused_call(x, w, bias,
                                                                     activation="silu"),
                 "conv1d_fwd_bf16"),
                ("committed, no SiLU", lambda: kernel.conv1d_fused_call(x, w, bias,
                                                                        activation="none"),
                 "conv1d_fwd_bf16"),
                ("copy_ of the x slice", lambda: out.copy_(x), "")):
            dev = _device_ms(run, key, reps)
            rows.append(dict(yardstick=what, shape=label, device_ms=dev, bound_ms=bound))
            print(f"yardstick {what:22s} {label:30s} device "
                  f"{'none' if dev is None else f'{dev:.4f}'} ms; bound {bound:.4f} ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_choices: no CUDA device", file=sys.stderr)
        return 2
    card = bwd_choices._card()
    print(f"card: {card}")
    libs = {"committed": (None, None)}
    for i, (name, (lines, *geom)) in enumerate(CHOICES.items()):
        lib = (bwd_choices.variant(f"conv1d_fused_fwd_bf16_choice{i}", lines, kernel.LIB_BF16,
                                   VARIANTS) if lines else kernel.LIB_BF16)
        libs[name] = (lib, tuple(geom))
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(),
                      {id(v[0]): v[0] for v in libs.values() if v[0] is not None}.values()))
    rows = times(libs, args.reps) + yardsticks(args.reps)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
