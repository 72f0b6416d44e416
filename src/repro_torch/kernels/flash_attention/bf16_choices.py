"""What the bf16 flash wrappers' two host-side choices do, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bf16_choices \
        [--out build/flash_bf16_choices.json]

(a) The block order (`kernel.head_major`): at the bf16 training layers
(`SHAPES`), the forward's and the backward's device time a call
(`torch.profiler`, the kernels' own time; the backward's is its delta and
main kernels') with the blocks ordered a (batch, kv head) at a time and
over all heads, whatever the rule picks, in two alternating rounds.
Beside each, the rule's pick.

(b) The wrappers' argument-signature cache (`kernel.CHECKED`): at the
host-bound shapes (`HOST_SHAPES`), each wrapper's host time a call (the
wall time of 200 calls queued without a synchronisation) and its
CUDA-event time a call (50 calls back to back), with the cache and with
it emptied before every call (the full checks each time), in two
alternating rounds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib

import torch

from repro_torch.convserve.runtime.clock import RealClock
from repro_torch.kernels.conv1d_fused.compare import device_ms
from repro_torch.kernels.flash_attention import backward
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.step_clocks import _card, _events_ms

# (label, (b, hq, hkv, sq, sk, hd, vd, causal)): the bf16 training layers
SHAPES = (
    ("gemma3 global", (4, 4, 1, 1024, 1024, 256, 256, True)),
    ("moonshot", (4, 16, 16, 1024, 1024, 128, 128, True)),
    ("deepseek MLA", (4, 128, 128, 1024, 1024, 192, 128, True)),
    ("deepseek MTP", (4, 128, 128, 1023, 1023, 56, 56, True)),
    ("seamless encoder", (4, 16, 16, 1024, 1024, 64, 64, False)),
    ("seamless decoder self", (4, 16, 16, 512, 512, 64, 64, True)),
)
# the shapes whose calls are shortest on the card: the served cross
# attention at Sq 1, gemma3's served global layer, seamless's decoder self
HOST_SHAPES = (
    ("seamless cross Sq1", (4, 16, 16, 1, 1024, 64, 64, False)),
    ("gemma3 global S700", (4, 4, 1, 700, 700, 256, 256, True)),
    ("seamless decoder self", (4, 16, 16, 512, 512, 64, 64, True)),
)


@contextlib.contextmanager
def block_order(grouped: bool):
    """Both wrappers with the blocks ordered a (batch, kv head) at a time
    (`grouped`) or over all heads, at every shape."""
    rule = flash_kernel.head_major
    pick = lambda *args: grouped  # noqa: E731
    backward.work_list.cache_clear()
    backward._device_items.cache_clear()
    flash_kernel.head_major = backward.head_major = pick
    try:
        yield
    finally:
        flash_kernel.head_major = backward.head_major = rule
        backward.work_list.cache_clear()
        backward._device_items.cache_clear()


def _operands(shape, seed: int = 0):
    b, hq, hkv, sq, sk, hd, vd, causal = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(h, s, d):  # (B, H, S, d) views of the model's (B, S, H, d)
        return torch.randn(b, s, h, d, device=dev, generator=gen).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, do = mk(hq, sq, hd), mk(hkv, sk, hd), mk(hkv, sk, vd), mk(hq, sq, vd)
    kw = dict(causal=causal, window=0)
    o, lse = flash_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
    fwd = lambda: flash_kernel.flash_attention_call(q, k, v, **kw)  # noqa: E731
    bwd = lambda: backward.flash_attention_bwd_call(q, k, v, o, lse, do, **kw)  # noqa: E731
    return fwd, bwd


def _host_us(fn, calls: int = 200) -> float:
    clock = RealClock()
    fn()
    torch.cuda.synchronize()
    t0 = clock.now()
    for _ in range(calls):
        fn()
    us = (clock.now() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _uncached(fn):
    def call():
        flash_kernel.CHECKED.clear()
        return fn()
    return call


def order_rows(card: str) -> list:
    rows = []
    for label, shape in SHAPES:
        b, hq, hkv, sq, sk, hd, vd, causal = shape
        row = dict(layer=label, shape=list(shape), card=card,
                   rule=flash_kernel.head_major(b, hkv, sk, hd, vd, torch.bfloat16),
                   forward={"grouped": [], "all heads": []},
                   backward={"grouped": [], "all heads": []})
        for _ in range(2):
            for grouped in (True, False):
                with block_order(grouped):
                    fwd, bwd = _operands(shape)
                    key = "grouped" if grouped else "all heads"
                    row["forward"][key].append(device_ms(fwd, 20, "flash_fwd_bf16"))
                    row["backward"][key].append(device_ms(bwd, 10, "flash_bwd"))
                    del fwd, bwd
        torch.cuda.empty_cache()
        print(f"{label} B{b} Hq{hq} Hkv{hkv} S{sq} hd {hd}/{vd}: rule picks "
              f"{'grouped' if row['rule'] else 'all heads'}; device ms a call, two rounds:")
        for part in ("forward", "backward"):
            print(f"  {part:8s} " + "  ".join(
                f"{key} " + " / ".join(f"{ms:.4f}" for ms in row[part][key])
                for key in ("grouped", "all heads")))
        rows.append(row)
    return rows


def cache_rows(card: str) -> list:
    rows = []
    for label, shape in HOST_SHAPES:
        fwd, bwd = _operands(shape)
        row = dict(layer=label, shape=list(shape), card=card)
        for part, fn in (("forward", fwd), ("backward", bwd)):
            r = {"cached": {"host_us": [], "events_ms": []},
                 "checked": {"host_us": [], "events_ms": []}}
            for _ in range(2):
                for key, call in (("cached", fn), ("checked", _uncached(fn))):
                    r[key]["host_us"].append(_host_us(call))
                    r[key]["events_ms"].append(_events_ms(call, reps=50))
            row[part] = r
            print(f"{label} {part}: " + "; ".join(
                f"{key} host " + " / ".join(f"{us:.2f}" for us in r[key]["host_us"])
                + " us, events " + " / ".join(f"{ms:.4f}" for ms in r[key]["events_ms"])
                + " ms" for key in ("cached", "checked")))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    card = _card()
    print(f"card: {card}")
    out = dict(card=card, block_order=order_rows(card), signature_cache=cache_rows(card))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
