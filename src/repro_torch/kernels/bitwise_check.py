"""Hold the flash-attention, causal-conv1d and decode-MLP kernels bitwise
against an earlier version of their sources, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.bitwise_check --old DIR \
        [--out build/bitwise_check.json]

DIR holds the earlier `flash_attention.cu` and `conv1d_fused.cu`, e.g.
from `git show <commit>:src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu` and the same for the conv1d source, and, when it
holds an earlier `flash_attention_bwd.cu` (commit 457bda9 or later: the
work-list entry point), the flash backward is compared too, at the same
flash cases (dq, dk, dv from the current forward's o and lse and a
seeded dO), and, when it holds an earlier `decode_mlp.cu`, the decode
MLP at the served and ragged shapes (`DECODE_MLP`).  Each old source
is built as a `_build.CudaLibrary` of its own and swapped in as the
wrapper's `LIB` between calls on the same inputs.  The flash entry point
gained an `lse` pointer after the first versions (the log-sum-exp that
training's backward reads), then v's head dim beside q's: an old source
is called without what its entry point lacks (read off its signature),
and the current kernel's output is compared both without and with the
lse written.  The cases are every head dim and every tap count (flash at hd
16, 32, 64, 80, 112, 128 and 256, causal with and without a window,
non-causal, GQA; conv1d at K 1..8 with float4 and single-float units,
SiLU on and off; the decode MLP at gemma3-1b's, zamba2-7b's and
seamless-m4t-medium's widths and two ragged shapes); the comparisons
are at fp32, the instantiations every earlier source has.  An old source
that lacks a head dim fails that case.
Every output pair must be bitwise equal; the run exits 1 otherwise.  The
one exception is a head dim whose accumulation scheme the current source
changed on purpose (`SCHEME_CHANGED`: hd 64 moved to fresh fragments,
for seamless-m4t-medium's 1,024 unmasked keys): against an old source
without the change its forward is reported, not held, and both versions
are timed at that head dim's served shapes (`SCHEME_TIMED`, the model's
layout; CUDA events, median of 20 calls, in the order current, old, old,
current) beside each one's max rel err against the plain version.  Rows
go to `--out` as JSON with the card's name and power limit.

`--record PATH` also writes the SHA-256 of the old flash source's output
at every flash case, with the nvcc release that built it, so that a run
without the old source can hold the current kernel to it
(`check_recorded`; `chip_smoke.py` does, against `RECORDED`, the outputs
of the flash source at commit f69b32c).  The digests are comparable only
under the same nvcc release on the same card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv1d_fused import conv1d_fused
from repro_torch.kernels.conv1d_fused import kernel as conv1d_kernel
from repro_torch.kernels.decode_mlp import decode_mlp
from repro_torch.kernels.decode_mlp import kernel as mlp_kernel
from repro_torch.kernels.flash_attention import backward as flash_bwd
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel

FLASH = [
    # (B, Hq, Hkv, Sq, Sk, hd, causal, window)
    (b, hq, hkv, s, sk, hd, causal, window)
    for hd in (16, 32, 64, 80, 112, 128, 256)
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

DECODE_MLP = [
    # (B, d, f): the served widths, a ragged float4 shape and single floats
    (4, 1152, 6912), (2, 3584, 14336), (1, 1024, 4096), (11, 200, 700), (3, 64, 33),
]


RECORDED = pathlib.Path(__file__).parent / "flash_attention" / "recorded_outputs.json"
# head dims whose forward changed its accumulation scheme on purpose, with
# the text of the current source's `Cfg::kFreshAcc` that marks the change:
# an old source without it computes other bits there
SCHEME_CHANGED = {64: "DK == 64"}
# where a changed head dim is served, (label, (B, Hq, Hkv, Sq, Sk, causal)):
# seamless-m4t-medium's encoder, decoder self-attention and cross attention
# at prefill and at a decode step over 1,024 frames
SCHEME_TIMED = {64: (
    ("seamless encoder", (4, 16, 16, 1024, 1024, False)),
    ("seamless decoder self", (4, 16, 16, 128, 128, True)),
    ("seamless cross", (4, 16, 16, 128, 1024, False)),
    ("seamless cross decode", (4, 16, 16, 1, 1024, False)),
)}


def flash_operands(dev):
    """(case, q, k, v) for every flash case, from one seeded generator."""
    gen = np.random.default_rng(0)
    for case in FLASH:
        b, hq, hkv, sq, sk, hd = case[:6]
        yield case, *(torch.tensor(gen.standard_normal(shape), dtype=torch.float32, device=dev)
                      for shape in ((b, hq, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd)))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def check_recorded(path: pathlib.Path = RECORDED) -> dict:
    """The current flash kernel's output, without and with the lse
    written, against the digests `--record` wrote: ``comparable`` is False
    (and nothing is compared) when this nvcc release or the case list is
    not the recorded one; ``mismatched`` lists the cases whose bits
    differ."""
    rec = json.loads(pathlib.Path(path).read_text())
    out = dict(nvcc=_build.nvcc_version(), recorded_nvcc=rec["nvcc"], source=rec["source"],
               cases=len(rec["digests"]), mismatched=[])
    out["comparable"] = out["nvcc"] == rec["nvcc"] and rec["cases"] == [list(c) for c in FLASH]
    if not out["comparable"]:
        return out
    for (case, q, k, v), want in zip(flash_operands(torch.device("cuda")), rec["digests"],
                                     strict=True):
        causal, window = case[6], case[7]
        y = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window)
        y_lse, _ = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                                     return_lse=True)
        if digest(y) != want or digest(y_lse) != want:
            out["mismatched"].append(list(case))
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# the current flash entry point's `lse` pointer and v head dim: earlier
# sources lack the head dim (all before this one) or both (before f69b32c)
_LSE, _HD, _VD = 4, 10, 11


class _Earlier:
    """An earlier flash source, called through the current wrapper: the
    arguments its entry point lacks are dropped (`drop`: the `lse`
    pointer, argument 4, which must then be null; v's head dim, argument
    11, which must then equal q's, argument 10)."""

    def __init__(self, path: pathlib.Path):
        text = path.read_text()
        sig = text[text.index('extern "C" int flash_attention_launch('):]
        sig = sig[:sig.index(")")]
        self.drop = ([] if "lse" in sig else [_LSE]) + ([] if "int vd" in sig else [_VD])
        self.changed = {hd for hd, mark in SCHEME_CHANGED.items() if mark not in text}
        self.lib = _build.CudaLibrary(path, "flash_attention_old", {
            "flash_attention_launch": [t for i, t in enumerate(flash_kernel.ARGTYPES)
                                       if i not in self.drop]})

    def launch(self, name, device, *args):
        if _LSE in self.drop and args[_LSE] is not None:
            raise ValueError("an earlier flash source cannot write the lse")
        if _VD in self.drop and args[_HD] != args[_VD]:
            raise ValueError("an earlier flash source takes one head dim")
        self.lib.launch(name, device, *(a for i, a in enumerate(args) if i not in self.drop))


class _EarlierBwd:
    """An earlier flash backward source.  One whose entry point takes one
    head dim (read off its signature) is called without v's (argument 18
    of the current one), which must then equal q's (argument 17)."""

    _HD, _VD = 17, 18

    def __init__(self, path: pathlib.Path):
        text = path.read_text()
        sig = text[text.index('extern "C" int flash_attention_bwd_launch('):]
        self.one_dim = "int vd" not in sig[:sig.index(")")]
        drop = [self._VD] if self.one_dim else []
        self.lib = _build.CudaLibrary(path, "flash_attention_bwd_old", {
            "flash_attention_bwd_launch": [t for i, t in enumerate(flash_bwd.ARGTYPES)
                                           if i not in drop]})

    def launch(self, name, device, *args):
        if not self.one_dim:
            self.lib.launch(name, device, *args)
            return
        if args[self._HD] != args[self._VD]:
            raise ValueError("an earlier flash backward source takes one head dim")
        self.lib.launch(name, device, *args[:self._VD], *args[self._VD + 1:])


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


def _event_ms(fn, reps: int = 20) -> float:
    """Median of `reps` calls of `fn`, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_changed(old_flash: _Earlier, dev) -> list:
    """The current and the old flash forward at the served shapes of each
    head dim whose scheme changed: ms by CUDA events (current, old, old,
    current) and each one's max rel err against `attention_ref`."""
    gen = np.random.default_rng(2)
    rows = []
    for hd in sorted(old_flash.changed):
        for label, (b, hq, hkv, sq, sk, causal) in SCHEME_TIMED.get(hd, ()):
            q, k, v = (torch.tensor(gen.standard_normal((b, s, h, hd)), dtype=torch.float32,
                                    device=dev).transpose(1, 2)
                       for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
            run = lambda: flash_attention(q, k, v, causal=causal)
            ref = attention_ref(q, k, v, causal=causal)
            times = {"current": [], "old": []}
            errs = {}
            for which in ("current", "old", "old", "current"):
                new_lib = flash_kernel.LIB
                if which == "old":
                    flash_kernel.LIB = old_flash
                try:
                    times[which].append(_event_ms(run))
                    y = run()
                    torch.cuda.synchronize()
                finally:
                    flash_kernel.LIB = new_lib
                errs[which] = float((y - ref).abs().max() / ref.abs().max())
            rows.append(dict(kernel="flash_attention_time", hd=hd, label=label,
                             shape=[b, hq, hkv, sq, sk], causal=causal, ms_current=times["current"],
                             ms_old=times["old"], max_rel_err_current=errs["current"],
                             max_rel_err_old=errs["old"]))
            print(f"flash hd {hd:3d} {label} B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} causal={causal}: "
                  f"current {' / '.join(f'{t:.4f}' for t in times['current'])} ms, old "
                  f"{' / '.join(f'{t:.4f}' for t in times['old'])} ms (CUDA events, median of "
                  f"20); max rel err vs plain current {errs['current']:.3e}, old "
                  f"{errs['old']:.3e}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--record", type=pathlib.Path, default=None,
                    help="write the old flash outputs' digests here")
    ap.add_argument("--label", default=None,
                    help="what the old sources are, for --record (default: --old)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    old_flash = _Earlier(args.old / "flash_attention.cu")
    old_conv = _build.CudaLibrary(
        args.old / "conv1d_fused.cu", "conv1d_fused_old",
        {"conv1d_fused_launch": [ctypes.c_void_p] * 6})
    rows, bad, digests = [], 0, []
    for (b, hq, hkv, sq, sk, hd, causal, window), q, k, v in flash_operands(dev):
        y, y_old = _both(flash_kernel, old_flash, lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        y_lse, _ = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                                     return_lse=True)
        torch.cuda.synchronize()
        digests.append(digest(y_old))
        same, same_lse = bool(torch.equal(y, y_old)), bool(torch.equal(y_lse, y_old))
        changed = hd in old_flash.changed
        bad += not (same and same_lse) and not changed
        rows.append(dict(kernel="flash_attention", hd=hd, shape=[b, hq, hkv, sq, sk],
                         causal=causal, window=window, bitwise_equal=same,
                         bitwise_equal_with_lse=same_lse, scheme_changed=changed))
        print(f"flash hd {hd:3d} B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} causal={causal} "
              f"window={window}: bitwise equal {same}, with lse written {same_lse}"
              + (" (not held: the old source sums this head dim on one chain)"
                 if changed else ""))
    rows += time_changed(old_flash, dev)
    gen = np.random.default_rng(1)
    mk = lambda shape, s=1.0: torch.tensor(gen.standard_normal(shape) * s,
                                           dtype=torch.float32, device=dev)
    if (args.old / "flash_attention_bwd.cu").exists():
        old_bwd = _EarlierBwd(args.old / "flash_attention_bwd.cu")
        for (b, hq, hkv, sq, sk, hd, causal, window), q, k, v in flash_operands(dev):
            o, lse = flash_kernel.flash_attention_call(q, k, v, causal=causal, window=window,
                                                       return_lse=True)
            do = mk(tuple(o.shape))
            g, g_old = _both(flash_bwd, old_bwd, lambda: flash_bwd.flash_attention_bwd_call(
                q, k, v, o, lse, do, causal=causal, window=window))
            same = all(torch.equal(a, c) for a, c in zip(g, g_old))
            bad += not same
            rows.append(dict(kernel="flash_attention_bwd", hd=hd, shape=[b, hq, hkv, sq, sk],
                             causal=causal, window=window, bitwise_equal=same))
            print(f"flash backward hd {hd:3d} B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} "
                  f"causal={causal} window={window}: dq, dk, dv bitwise equal {same}")
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
    if (args.old / "decode_mlp.cu").exists():
        old_mlp = _build.CudaLibrary(args.old / "decode_mlp.cu", "decode_mlp_old",
                                     {"decode_mlp_launch": [ctypes.c_void_p] * 8})
        for b, d, f in DECODE_MLP:
            x, w1, w3 = mk((b, d)), mk((d, f), d ** -0.5), mk((d, f), d ** -0.5)
            w2 = mk((f, d), f ** -0.5)
            y, y_old = _both(mlp_kernel, old_mlp, lambda: decode_mlp(x, w1, w3, w2))
            same = bool(torch.equal(y, y_old))
            bad += not same
            rows.append(dict(kernel="decode_mlp", shape=[b, d, f], bitwise_equal=same))
            print(f"decode_mlp B{b} d{d} f{f}: bitwise equal {same}")
    card = _card()
    n_changed = sum(r.get("scheme_changed", False) for r in rows)
    n_held = sum(r["kernel"] != "flash_attention_time" for r in rows) - n_changed
    print(f"card: {card}; {n_held - bad}/{n_held} held cases "
          f"bitwise equal ({n_changed} at a changed accumulation scheme not held)")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    if args.record is not None:
        args.record.write_text(json.dumps(dict(
            source=args.label or str(args.old), nvcc=_build.nvcc_version(), card=card,
            cases=[list(c) for c in FLASH], digests=digests), indent=1) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
