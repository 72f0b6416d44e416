"""Hold the flash-attention and causal-conv1d kernels bitwise against an
earlier version of their sources, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.bitwise_check --old DIR \
        [--out build/bitwise_check.json]

DIR holds the earlier `flash_attention.cu` and `conv1d_fused.cu`, e.g.
from `git show <commit>:src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu` and the same for the conv1d source.  Both C entry
points keep their signatures across those versions, so each old source is
built as a `_build.CudaLibrary` of its own and swapped in as the
wrapper's `LIB` between calls on the same inputs.  The cases are every
head dim and every tap count both versions take (flash at hd 16, 32, 64,
128 and 256, causal with and without a window, non-causal, GQA; conv1d
at K 1..8 with float4 and single-float units, SiLU on and off).  Every
output pair must be bitwise equal; the run exits 1 otherwise.  Rows go to
`--out` as JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import conv1d_fused
from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel

FLASH = [
    # (B, Hq, Hkv, Sq, Sk, hd, causal, window)
    (b, hq, hkv, s, sk, hd, causal, window)
    for hd in (16, 32, 64, 128, 256)
    for (b, hq, hkv, s, sk, causal, window) in (
        (2, 4, 1, 300, 300, True, 0),
        (1, 4, 2, 200, 200, True, 64),
        (1, 2, 2, 77, 256, False, 0),
    )
]
CONV1D = [
    # (B, L, D, K, row stride, column offset, activation)
    (b, length, d, k, row, off, act)
    for k in range(1, 9)
    for (b, length, d, row, off, act) in (
        (4, 768, 4352, 8512, 4096, "silu"),
        (2, 203, 71, 200, 65, "none"),
    )
]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _both(mod, old_lib, fn):
    """(new output, old output) of `fn` with the wrapper's library, then
    the old source's, on the same inputs."""
    new_lib = mod.LIB
    y_new = fn()
    mod.LIB = old_lib
    try:
        y_old = fn()
    finally:
        mod.LIB = new_lib
    torch.cuda.synchronize()
    return y_new, y_old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    old_flash = _build.CudaLibrary(
        args.old / "flash_attention.cu", "flash_attention_old",
        {"flash_attention_launch": flash_kernel.ARGTYPES})
    old_conv = _build.CudaLibrary(
        args.old / "conv1d_fused.cu", "conv1d_fused_old",
        {"conv1d_fused_launch": [ctypes.c_void_p] * 6})
    gen = np.random.default_rng(0)
    mk = lambda shape, s=1.0: torch.tensor(gen.standard_normal(shape) * s,
                                           dtype=torch.float32, device=dev)
    rows, bad = [], 0
    for b, hq, hkv, sq, sk, hd, causal, window in FLASH:
        q, k, v = mk((b, hq, sq, hd)), mk((b, hkv, sk, hd)), mk((b, hkv, sk, hd))
        y, y_old = _both(flash_kernel, old_flash, lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        same = bool(torch.equal(y, y_old))
        bad += not same
        rows.append(dict(kernel="flash_attention", hd=hd, shape=[b, hq, hkv, sq, sk],
                         causal=causal, window=window, bitwise_equal=same))
        print(f"flash hd {hd:3d} B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} causal={causal} "
              f"window={window}: bitwise equal {same}")
    for b, length, d, k, row, off, act in CONV1D:
        x = mk((b, length, row))[..., off:off + d]
        w, bias = mk((k, d), 0.5), mk((d,), 0.1)
        y, y_old = _both(conv1d_kernel, old_conv, lambda: conv1d_fused(
            x, w, bias, activation=act))
        same = bool(torch.equal(y, y_old))
        bad += not same
        rows.append(dict(kernel="conv1d_fused", k=k, shape=[b, length, d, row, off],
                         activation=act, bitwise_equal=same))
        print(f"conv1d K {k} B{b} L{length} D{d} row {row} offset {off} {act}: "
              f"bitwise equal {same}")
    card = _card()
    print(f"card: {card}; {len(rows) - bad}/{len(rows)} cases bitwise equal")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
