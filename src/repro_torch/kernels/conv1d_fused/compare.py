"""Time the causal-conv1d kernel at mamba2-1.3b's two served prefill waves:
over its block widths, beside a device-to-device copy of the same bytes,
and against an earlier version of its source.

    PYTHONPATH=src python -m repro_torch.kernels.conv1d_fused.compare \
        [--old DIR] [--reps 25] [--out build/conv1d_compare.json]

Needs one CUDA card.  The inputs are the served ones: x the xBC slice
(columns 4096..8447) of a (B, L, 8512) in-projection output, K 4, SiLU,
at B 4 L 768 and B 2 L 129, from seed 0.  Device times are
`torch.profiler`'s device events, the mean over `reps` calls.

1. Block widths: 64, 96 and 128 threads, launched straight through the C
   entry point and held bitwise against the wrapper's output; the
   wrapper's pick (`kernel.launch_geometry`) is marked.  Beside them, a
   yardstick of what the card's memory delivers: `copy_` of a contiguous
   (B, L, 4352) tensor into another (one read and one write of the
   kernel's x and out bytes).
2. With `--old DIR`: DIR holds an earlier `kernel.py` and its
   `csrc/conv1d_fused.cu`, e.g. the first version's
   (`git show 5c20b91:src/repro_torch/kernels/conv1d_fused/kernel.py`
   and the same for the source; that wrapper takes `strip`, which its
   caller set to min(128, L)).  Both wrappers run in the order old, new,
   new, old; each reading is the median of `reps` CUDA-event-timed calls
   (the wrapper's host path included) and the device time.  The outputs
   of old and new, and of two calls of new, must be bitwise equal; the
   run exits 1 otherwise.

Rows go to `--out` as JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels.conv1d_fused import kernel

WAVES = {"wave1 B4 L768": (4, 768), "wave2 B2 L129": (2, 129)}
D, ROW, OFFSET, K = 4352, 8512, 4096, 4  # mamba2-1.3b's xBC inside zxbcdt
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def operands(b: int, length: int, seed: int = 0):
    gen = np.random.default_rng(seed)
    mk = lambda shape, s: torch.tensor(gen.standard_normal(shape) * s, dtype=torch.float32,
                                       device="cuda")
    wide = mk((b, length, ROW), 1.0)
    return wide[..., OFFSET:OFFSET + D], mk((K, D), 0.5), mk((D,), 0.1)


def events_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event-timed calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def device_ms(fn, reps: int, key: str = "conv1d_fused_kernel"):
    """Mean device time per call of the device events whose names hold
    `key` (every device event for an empty key) that `fn` launches, from
    `torch.profiler`; None if it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA and key in e.key)
    return us / 1e3 / reps if us > 0 else None


def widths(reps: int) -> list:
    rows = []
    for label, (b, length) in WAVES.items():
        x, w, bias = operands(b, length)
        want = kernel.conv1d_fused_call(x, w, bias, activation="silu")
        out = torch.empty_like(want)
        bound = 4 * (2 * b * length * D + K * D + D) / HBM_BW * 1e3
        pick = kernel.launch_geometry(b, length, D, ROW)
        for threads in (64, 96, 128):
            g = dataclasses.replace(pick, threads=threads,
                                    n_cblocks=-(-D // (pick.vec * threads)))
            args = g.launch_args(length, D, ROW, K, True)

            def launch(args=args):
                kernel.LIB.launch("conv1d_fused_launch", x.device, x.data_ptr(), w.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), ctypes.addressof(args))

            out.zero_()
            launch()
            torch.cuda.synchronize()
            same = bool(torch.equal(out, want))
            dev = device_ms(launch, reps)
            rows.append(dict(wave=label, pick=g == pick, vec=g.vec, threads=threads,
                             blocks=g.n_blocks, device_ms=dev, bound_ms=bound,
                             bitwise_equal=same))
            print(f"width {label}  {'pick' if g == pick else '    '}  vec {g.vec} threads "
                  f"{threads:3d} blocks {g.n_blocks:5d}  device {dev} ms  bound {bound:.5f} ms"
                  f"  bitwise equal to the wrapper's: {same}")
            if not same:
                raise AssertionError(f"{label}: {threads} threads change the result")
        src = torch.randn((b, length, D), device="cuda")
        dst = torch.empty_like(src)
        dev = device_ms(lambda: dst.copy_(src), reps, key="")
        rows.append(dict(wave=label, copy_device_ms=dev, bound_ms=bound))
        print(f"copy  {label}  device-to-device copy_ of {src.numel() * 4} B: device {dev} ms")
    return rows


def load_old(path: pathlib.Path):
    """The earlier wrapper in `path`/kernel.py, registered in sys.modules
    before it runs (its dataclasses look their module up)."""
    spec = importlib.util.spec_from_file_location("conv1d_old_kernel", path / "kernel.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def ab(old_dir: pathlib.Path, reps: int) -> list:
    old = load_old(old_dir)
    rows = []
    ok = True
    for label, (b, length) in WAVES.items():
        x, w, bias = operands(b, length)
        sides = {
            "old": lambda: old.conv1d_fused_call(x, w, bias, strip=min(128, length),
                                                 activation="silu"),
            "new": lambda: kernel.conv1d_fused_call(x, w, bias, activation="silu"),
        }
        y_old, y_new, y_new2 = sides["old"](), sides["new"](), sides["new"]()
        torch.cuda.synchronize()
        same_old, same_twice = bool(torch.equal(y_old, y_new)), bool(torch.equal(y_new, y_new2))
        ok &= same_old and same_twice
        print(f"ab {label}: new bitwise equal to old: {same_old}; two calls of new bitwise "
              f"equal: {same_twice}")
        for side in ("old", "new", "new", "old"):
            ev, dev = events_ms(sides[side], reps), device_ms(sides[side], reps)
            rows.append(dict(wave=label, side=side, ms=ev, device_ms=dev,
                             bitwise_equal_old_new=same_old, bitwise_equal_twice=same_twice))
            print(f"ab {label} {side}: events {ev:.5f} ms  device {dev} ms")
    if not ok:
        raise AssertionError("the new kernel's output is not bitwise the old one's")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=pathlib.Path, default=None,
                    help="directory with an earlier kernel.py and csrc/conv1d_fused.cu")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}")
    result = {"card": card, "widths": widths(args.reps)}
    try:
        if args.old is not None:
            result["ab"] = ab(args.old, args.reps)
    finally:
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
