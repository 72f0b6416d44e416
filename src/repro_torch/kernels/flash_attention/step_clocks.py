"""Where a step of the flash backward's longest item spends its clocks, on
one card, and what `mma.sync` TF32 reaches there.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.step_clocks \
        [--out build/flash_bwd_step_clocks.json]

It copies `csrc/flash_attention_bwd.cu` under `build/` with `clock64()`
marks added to the dK/dV role (`instrument`), builds that copy, runs it
at gemma3-1b's two training layers (B 4, Hq 4, Hkv 1, S 1024, hd 256,
causal, window 0 and 512) and prints, for block 0 -- the work list's
first and longest item -- the clocks a step of: the wait for the step's
copies, issuing the next step's copies, the S / dP products, the trade
of hd halves, the P / dS epilogue (with the P hand-off), the barrier
before the dV / dK products, and those products; for one S warp and one
dP warp.  Beside them the CUDA-event time of a call with the marked copy
and with the committed kernel (the marks cost a little), and the rate of a kernel of
independent `mma.sync.m16n8k8` TF32 chains (132 x 4 blocks of 8 warps,
8 chains a thread).  The marks are a measurement copy only: the
committed kernel carries none.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import backward
from repro_torch.kernels.flash_attention import kernel as flash_kernel

PARTS = ("wait", "issue next copies", "S / dP products", "hd-half trade", "P / dS epilogue",
         "barrier", "dV / dK products")
LAYERS = (("global", 0), ("local w512", 512))
COPY = _build.BUILD_DIR.parent / "flash_bwd_step_clocks" / "flash_attention_bwd.cu"


def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"instrument: the backward source no longer holds {old[:60]!r}")
    return text.replace(old, new)


def instrument(text: str) -> str:
    """The backward source with clock marks in `step_p_ds` and the dK/dV
    role's step loop; block 0's sums land in `g_clocks` (thread 0, an S
    warp, and thread 160, a dP warp), read by `bwd_clocks`.  Appends the
    `mma.sync` rate kernel."""
    text = _edit(text, "namespace {\n", (
        "namespace {\n__device__ unsigned long long g_clocks[2][8];\n"
        "#define MARK(i) do { if (tc) { const unsigned long long now_ = clock64(); "
        "tc[i] += now_ - last; last = now_; } } while (0)\n"))
    text = _edit(text, "                                          int k0) {", (
        "                                          int k0, unsigned long long* tc = nullptr,\n"
        "                                          unsigned long long last = 0) {"))
    pv_half = ("    scores_half<C::PV>(part, dosh + 16 * rh * C::LDV + hf * (C::PV / 2), "
               "vsh + hf * (C::PV / 2),\n                       g, t);")
    text = _edit(text, pv_half, pv_half + "\n  MARK(2);")
    text = _edit(text, "  float* x = xsh + pair * 8 * 32 + lane;",
                 "  MARK(3);\n  float* x = xsh + pair * 8 * 32 + lane;")
    text = _edit(text, (
        "        dst[ds_t ? c * LDP + r : r * LDP + c] = ds;\n      }\n  }\n}"), (
        "        dst[ds_t ? c * LDP + r : r * LDP + c] = ds;\n      }\n  }\n  MARK(4);\n}"))
    text = _edit(text, (
        "  for (int it = 0; it < n; ++it) {\n"
        "    const int st = it & 1;\n"
        "    cp_wait_all();\n"
        "    __syncthreads();  // step it has landed; every warp is done with step it - 1\n"
        "    if (it + 1 < n) issue(it + 1, st ^ 1);\n"
        "    cp_commit();\n"
        "    const float* qsh"), (
        "  unsigned long long tcs[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  unsigned long long* tc = tcs;\n"
        "  unsigned long long last = clock64();\n"
        "  for (int it = 0; it < n; ++it) {\n"
        "    const int st = it & 1;\n"
        "    cp_wait_all();\n"
        "    __syncthreads();  // step it has landed; every warp is done with step it - 1\n"
        "    MARK(0);\n"
        "    if (it + 1 < n) issue(it + 1, st ^ 1);\n"
        "    cp_commit();\n"
        "    MARK(1);\n"
        "    const float* qsh"))
    text = _edit(text, (
        "                      sm.xsh, sm.xch, (lo + it % nq) * kB, k0);\n"
        "    __syncthreads();  // P^T and dS^T are whole"), (
        "                      sm.xsh, sm.xch, (lo + it % nq) * kB, k0, tc, last);\n"
        "    last = clock64();\n"
        "    __syncthreads();  // P^T and dS^T are whole\n"
        "    MARK(5);"))
    text = _edit(text, (
        "        add_into(adk, step);\n      }\n    }\n  }\n"
        "  cp_wait_all();  // where no step ran, the K / V copies"), (
        "        add_into(adk, step);\n      }\n    }\n    MARK(6);\n  }\n"
        "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 160)) {\n"
        "    for (int i = 0; i < 7; ++i) g_clocks[threadIdx.x == 160][i] = tcs[i];\n"
        "    g_clocks[threadIdx.x == 160][7] = n;\n  }\n"
        "  cp_wait_all();  // where no step ran, the K / V copies"))
    return text + """
extern "C" int bwd_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}

// independent mma.sync chains: 8 accumulators a thread, `iters` mma each
__global__ void mma_rate_kernel(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a, (uint32_t)i, (uint32_t)j);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int iters, void* stream) {
  mma_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    card = _card()
    COPY.parent.mkdir(parents=True, exist_ok=True)
    COPY.write_text(instrument(backward.SOURCE.read_text()))
    lib = _build.CudaLibrary(COPY, "flash_bwd_step_clocks", {
        "flash_attention_bwd_launch": backward.ARGTYPES,
        "bwd_clocks": [ctypes.c_void_p],
        "mma_rate_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    })
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, s, hd = 4, 4, 1, 1024, 256
    mk = lambda h: torch.randn(b, s, h, hd, device=dev, generator=gen).transpose(1, 2)
    q, k, v, do = mk(hq), mk(hkv), mk(hkv), mk(hq)
    rows = []
    print(f"card: {card}")
    for label, window in LAYERS:
        o, lse = flash_kernel.flash_attention_call(q, k, v, causal=True, window=window,
                                                   return_lse=True)
        run = lambda: backward.flash_attention_bwd_call(q, k, v, o, lse, do, causal=True,
                                                        window=window)
        committed = backward.LIB
        try:
            backward.LIB = lib
            marked_ms = _events_ms(run)
            buf = (ctypes.c_ulonglong * 16)()
            err = lib.fn("bwd_clocks")(ctypes.cast(buf, ctypes.c_void_p))
        finally:
            backward.LIB = committed
        if err:
            raise RuntimeError(f"bwd_clocks failed: CUDA error {err}")
        plain_ms = _events_ms(run)
        steps = buf[7]
        row = dict(layer=label, steps=steps, ms_events_marked=marked_ms,
                   ms_events_committed=plain_ms, card=card)
        for who, off in (("S warp", 0), ("dP warp", 8)):
            per = {part: buf[off + i] / steps for i, part in enumerate(PARTS)}
            row[who] = per
            print(f"{label}: block 0, {steps} steps, {who}: " + ", ".join(
                f"{part} {c:.0f}" for part, c in per.items()) +
                f"; {sum(per.values()):.0f} clk a step")
        print(f"{label}: events {marked_ms:.4f} ms with the marks, {plain_ms:.4f} ms without")
        rows.append(row)
    out = torch.empty(132 * 4 * 256, device=dev)
    iters = 4096
    launch = lambda: lib.launch("mma_rate_launch", dev, out.data_ptr(), 132 * 4, iters)
    ms = _events_ms(launch, reps=5)
    n_mma = 132 * 4 * 8 * iters * 8
    tflops = n_mma * 2 * 16 * 8 * 8 / ms / 1e9
    print(f"mma.sync.m16n8k8 TF32, 132 x 4 blocks x 8 warps x 8 chains: {tflops:.1f} TFLOP/s "
          f"({tflops / 495:.3f} of the 495 TFLOP/s TF32 peak)")
    rows.append(dict(mma_sync_tf32_tflops=tflops, card=card))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
