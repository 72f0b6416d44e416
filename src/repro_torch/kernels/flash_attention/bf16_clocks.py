"""Where a step of the bf16 flash kernels spends its clocks, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bf16_clocks \
        [--out build/flash_bf16_clocks.json]

It copies `csrc/flash_attention_bf16.cu` and `csrc/flash_attention_bwd_bf16.cu`
(with `csrc/hopper.cuh`) under `build/` with `clock64()` marks added to the
step loops (`instrument_forward`, `instrument_backward`), builds the copies,
runs them at the bf16 training layers of `SHAPES` and prints, summed over
thread 0 of every warpgroup and divided by the steps they ran, the clocks a
step of each part: the forward's team barrier, the wait for the step's TMA
copy, S, the softmax and P.V; in the backward's solo items (a warpgroup an
item) the barrier, the copy's wait, S and dP, P, dV's issue, dS and dK's
issue, and the wait for dV / dK (dK/dV items), or P and dS, the fragments
and dQ (dQ items); in the pair items (two warpgroups an item, hd 192 and
256) warpgroup 1's barrier, copy wait, dP, the wait for P, dS with its
products' issue, and their wait.  A warpgroup's clocks run while the SM's
other warpgroups issue too: a part's clocks are its wall time, not its own
instructions'.  Beside them each kernel's CUDA-event time with the marks and
without.  The marks are a measurement copy only: the committed kernels carry
none.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import backward
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.step_clocks import _card, _edit, _events_ms

# (label, (b, hq, hkv, s, hd, vd, causal)): the bf16 training layers
SHAPES = (
    ("gemma3 global", (4, 4, 1, 1024, 256, 256, True)),
    ("moonshot", (4, 16, 16, 1024, 128, 128, True)),
    ("deepseek MLA", (4, 128, 128, 1024, 192, 128, True)),
    ("deepseek MTP", (4, 128, 128, 1023, 56, 56, True)),
    ("seamless encoder", (4, 16, 16, 1024, 64, 64, False)),
)
# each instrumented loop: its slot in `g_clocks` (8 a loop: 7 parts, then
# the steps) and its parts
LOOPS = {
    "forward": (0, ("barrier", "copy wait", "S", "softmax", "P.V")),
    "dK/dV solo": (8, ("barrier", "copy wait", "S, dP", "P", "dV issue", "dS, dK issue",
                       "dV / dK wait")),
    "dQ solo": (16, ("barrier", "copy wait", "S, dP", "P, dS", "fragments", "dQ")),
    "dK/dV pair, warpgroup 1": (24, ("barrier", "copy wait", "dP", "P wait", "dS, dK issue",
                                     "dK wait")),
    "dQ pair, warpgroup 1": (32, ("barrier", "copy wait", "dP", "P wait", "dS, dQ issue",
                                  "dQ wait")),
}
COPIES = _build.BUILD_DIR.parent / "flash_bf16_clocks"
MARKS = r'''
__device__ unsigned long long g_clocks[40];
extern "C" int bf16_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long zero[40] = {};
    return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
}
#define MARK_INIT unsigned long long tc_[7] = {}; unsigned long long last_ = clock64();
#define MARK(i) do { const unsigned long long now_ = clock64(); tc_[i] += now_ - last_; \
                     last_ = now_; } while (0);
#define MARK_FLUSH(slot, steps) if ((threadIdx.x & 127) == 0) { \
    for (int i_ = 0; i_ < 7; ++i_) atomicAdd(&g_clocks[(slot) + i_], tc_[i_]); \
    atomicAdd(&g_clocks[(slot) + 7], (unsigned long long)(steps)); }
'''


def _function(text: str, name: str) -> tuple:
    """(start, end) of the device function `name` (to the next template)."""
    start = text.index(f"void {name}(")
    return start, text.index("template <int DK, int DV>", start)


def instrument_forward(text: str) -> str:
    """The bf16 forward with clock marks in `attend`'s step loop."""
    text = _edit(text, '#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + MARKS)
    a, b = _function(text, "attend")
    f = text[a:b]
    f = _edit(f, "  for (int it = 0; it < n_kv; ++it) {",
              "  MARK_INIT\n  for (int it = 0; it < n_kv; ++it) {")
    f = _edit(f, "    bar(barid, THREADS);  // the team", "    bar(barid, THREADS); MARK(0)  //")
    f = _edit(f, "    mbar_wait(full + 8 * st, (it >> 1) & 1);  // this step's",
              "    mbar_wait(full + 8 * st, (it >> 1) & 1); MARK(1)  //")
    f = _edit(f, "    fence_regs(s);\n", "    fence_regs(s); MARK(2)\n")
    f = _edit(f, "    // acc += bf16(P) V", "    MARK(3)\n    // acc += bf16(P) V")
    f = _edit(f, "    fence_regs(pa);\n  }\n",
              "    fence_regs(pa); MARK(4)\n  }\n  MARK_FLUSH(0, n_kv)\n")
    return text[:a] + f + text[b:]


def instrument_backward(text: str) -> str:
    """The bf16 backward with clock marks in both solo roles' step loops and
    in warpgroup 1's loop of both pair roles."""
    text = _edit(text, '#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + MARKS)
    a, b = _function(text, "dkdv_solo")
    f = text[a:b]
    f = _edit(f, "  for (int it = 0; it < n; ++it) {",
              "  MARK_INIT\n  for (int it = 0; it < n; ++it) {")
    f = _edit(f, "    bar(barid, 128);  // step it's", "    bar(barid, 128); MARK(0)  //")
    f = _edit(f, "    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's q and dO",
              "    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1); MARK(1)")
    f = _edit(f, "    fence_regs(dp);\n    // P^T", "    fence_regs(dp); MARK(2)\n    // P^T")
    f = _edit(f, "    // dV += bf16(P^T) dO", "    MARK(3)\n    // dV += bf16(P^T) dO")
    f = _edit(f, "    // dS^T = P^T (dP^T - delta)",
              "    MARK(4)\n    // dS^T = P^T (dP^T - delta)")
    f = _edit(f, "    wg_commit();\n    wg_wait<0>();\n    fence_regs(adv);",
              "    MARK(5) wg_commit();\n    wg_wait<0>();\n    fence_regs(adv);")
    f = _edit(f, "    fence_regs(al);\n  }\n",
              "    fence_regs(al); MARK(6)\n  }\n  MARK_FLUSH(8, n)\n")
    text = text[:a] + f + text[b:]
    a, b = _function(text, "dq_solo")
    f = text[a:b]
    f = _edit(f, "  for (int it = 0; it < n; ++it) {",
              "  MARK_INIT\n  for (int it = 0; it < n; ++it) {")
    f = _edit(f, "    bar(barid, 128);  // the statistics", "    bar(barid, 128); MARK(0)  //")
    f = _edit(f, "    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's K and V",
              "    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1); MARK(1)")
    f = _edit(f, "    fence_regs(dp);\n    const float dl",
              "    fence_regs(dp); MARK(2)\n    const float dl")
    f = _edit(f, "    // dQ += dS K, the small part first",
              "    MARK(3)\n    // dQ += dS K, the small part first")
    f = _edit(f, "    fence_regs(adq);\n    wg_fence();",
              "    MARK(4) fence_regs(adq);\n    wg_fence();")
    f = _edit(f, "    fence_regs(al);\n  }\n",
              "    fence_regs(al); MARK(5)\n  }\n  MARK_FLUSH(16, n)\n")
    text = text[:a] + f + text[b:]
    for name, slot in (("dkdv_pair", 24), ("dq_pair", 32)):
        a, b = _function(text, name)
        f = text[a:b]
        i = f.index("  } else {")  # warpgroup 1's loop
        g = f[i:]
        g = _edit(g, "    for (int it = 0; it < n; ++it) {",
                  "    MARK_INIT\n    for (int it = 0; it < n; ++it) {")
        g = _edit(g, "      bar(1, kThreads);\n", "      bar(1, kThreads); MARK(0)\n")
        g = _edit(g, "      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);\n",
                  "      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1); MARK(1)\n")
        g = _edit(g, "      bar(2, kThreads);  // P", "      MARK(2) bar(2, kThreads); MARK(3)  //")
        ind = "      " if "      wg_commit();\n      wg_wait<0>();\n" in g else "        "
        g = _edit(g, f"{ind}wg_commit();\n{ind}wg_wait<0>();\n",
                  f"{ind}MARK(4) wg_commit();\n{ind}wg_wait<0>(); MARK(5)\n")
        j = g.index("\n    }\n", g.index("MARK(5)")) + 1
        g = g[:j] + f"    }}\n    MARK_FLUSH({slot}, n)\n" + g[j + 6:]
        text = text[:a] + f[:i] + g + text[b:]
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    card = _card()
    COPIES.mkdir(parents=True, exist_ok=True)
    shutil.copy(flash_kernel.SOURCE.with_name("hopper.cuh"), COPIES / "hopper.cuh")
    fwd_copy, bwd_copy = COPIES / "flash_attention_bf16.cu", COPIES / "flash_attention_bwd_bf16.cu"
    fwd_copy.write_text(instrument_forward(flash_kernel.SOURCE_BF16.read_text()))
    bwd_copy.write_text(instrument_backward(backward.SOURCE_BF16.read_text()))
    clocks = {"bf16_clocks": [ctypes.c_void_p, ctypes.c_int]}
    fwd_lib = _build.CudaLibrary(fwd_copy, "flash_bf16_clocks",
                                 {"flash_attention_bf16_launch": flash_kernel.ARGTYPES_BF16, **clocks})
    bwd_lib = _build.CudaLibrary(bwd_copy, "flash_bwd_bf16_clocks",
                                 {"flash_attention_bwd_bf16_launch": backward.ARGTYPES, **clocks})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    print(f"card: {card}")
    for label, (b, hq, hkv, s, hd, vd, causal) in SHAPES:
        mk = lambda h, d: torch.randn(b, s, h, d, device=dev, generator=gen).to(
            torch.bfloat16).transpose(1, 2)
        q, k, v, do = mk(hq, hd), mk(hkv, hd), mk(hkv, vd), mk(hq, vd)
        kw = dict(causal=causal, window=0)
        o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
        fwd = lambda: flash_kernel.flash_attention_call(q, k, v, **kw)
        bwd = lambda: backward.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)
        row = dict(layer=label, shape=[b, hq, hkv, s, hd, vd], causal=causal, card=card,
                   ms_events=dict(forward=_events_ms(fwd), backward=_events_ms(bwd)))
        committed = flash_kernel.LIB_BF16, backward.LIB_BF16
        try:
            flash_kernel.LIB_BF16, backward.LIB_BF16 = fwd_lib, bwd_lib
            row["ms_events_marked"] = dict(forward=_events_ms(fwd), backward=_events_ms(bwd))
            sums = []
            for lib, call in ((fwd_lib, fwd), (bwd_lib, bwd)):
                buf = (ctypes.c_ulonglong * 40)()
                lib.fn("bf16_clocks")(None, 1)
                call()
                torch.cuda.synchronize()
                err = lib.fn("bf16_clocks")(ctypes.cast(buf, ctypes.c_void_p), 0)
                if err:
                    raise RuntimeError(f"bf16_clocks failed: CUDA error {err}")
                sums.append(list(buf))
        finally:
            flash_kernel.LIB_BF16, backward.LIB_BF16 = committed
        ev, marked = row["ms_events"], row["ms_events_marked"]
        print(f"{label} B{b} Hq{hq} Hkv{hkv} S{s} hd {hd}/{vd} causal={causal}: events "
              f"forward {ev['forward']:.4f} ms ({marked['forward']:.4f} marked), backward "
              f"{ev['backward']:.4f} ms ({marked['backward']:.4f} marked)")
        for loop, (slot, parts) in LOOPS.items():
            vals = sums[0] if loop == "forward" else sums[1]
            steps = vals[slot + 7]
            if not steps:
                continue
            per = {part: vals[slot + i] / steps for i, part in enumerate(parts)}
            row[loop] = dict(steps=steps, clocks_a_step=per)
            print(f"  {loop}: {steps} warpgroup steps, {sum(per.values()):.0f} clk a step: "
                  + ", ".join(f"{part} {c:.0f}" for part, c in per.items()))
        rows.append(row)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
