"""Where a bf16 model's runs on the card and on the CPU part.

One wave of two prompts (600 and 40 tokens) is prefilled and decoded for
a few teacher-forced steps through a randomly initialised cut of a
registered config, in several variants of the same weights:

- ``card`` / ``cpu``: bf16 as served (the kernels on the card, their
  plain versions on the CPU);
- ``card_plain``, ``card_plain_<kernel>``: on the card with every kernel,
  or one, swapped for its plain version;
- ``card_exact`` / ``cpu_exact``: plain versions, and every product
  (matmul, einsum, bmm) summed in float64 and rounded once to the dtype
  it would have returned, so that only the port's rounding points are
  left and the summation order no longer matters;
- ``card_f32`` / ``cpu_f32``: the same weights widened to f32 (TF32
  off).

It prints and writes, for each pair, the largest logits error relative to
the second run's max |logits| at the prefill and over the decode steps,
and for the first seed each layer's output error along the stack.  Run:

    PYTHONPATH=src python -m repro_torch.serve.bf16_drift --arch zamba2-7b \\
        --layers 2 --shared-period 1 --seeds 0 1 2 --out drift.json

It needs a card; ``--cpu-only`` runs the CPU variants alone (small cuts).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

PROMPTS = (600, 40)
MAX_LEN = 704
KERNELS = ("flash", "decode_mlp", "conv1d")
PAIRS = (
    ("card", "cpu"), ("card", "cpu_f32"), ("cpu", "cpu_f32"),
    ("card_f32", "cpu_f32"), ("card_plain", "cpu"), ("card", "card_plain"),
    ("card_plain_flash", "card"), ("card_plain_decode_mlp", "card"),
    ("card_plain_conv1d", "card"),
    ("card_exact", "cpu_exact"), ("card", "card_exact"), ("cpu", "cpu_exact"),
    ("card_exact", "cpu_f32"),
)
_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.einsum,
             torch.bmm, torch.Tensor.bmm, torch.mm, torch.Tensor.mm, F.linear}


class ExactProducts(TorchFunctionMode):
    """Every floating product in float64, rounded once to the dtype the
    plain call returns (its operands' promoted dtype)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS or "out_dtype" in kwargs:
            return func(*args, **kwargs)
        flat = [a for x in args for a in (x if isinstance(x, (list, tuple)) else (x,))]
        ts = [a for a in flat if isinstance(a, torch.Tensor)]
        if not ts or not all(t.is_floating_point() for t in ts):
            return func(*args, **kwargs)
        dtype = ts[0].dtype
        for t in ts[1:]:
            dtype = torch.promote_types(dtype, t.dtype)

        def wide(x):
            if isinstance(x, torch.Tensor):
                return x.double()
            if isinstance(x, (list, tuple)):
                return type(x)(wide(a) for a in x)
            return x

        return func(*wide(args), **kwargs).to(dtype)


@contextlib.contextmanager
def plain_kernels(which=KERNELS):
    """The models' kernel wrappers replaced by their plain versions, on
    any device."""
    from repro_torch.kernels.conv1d_fused.ref import conv1d_ref
    from repro_torch.kernels.decode_mlp.ref import decode_mlp_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention, mamba, mlp

    def flash(q, k, v, *, causal=True, window=0):
        return attention_ref(q, k, v, causal=causal, window=int(window or 0))

    def conv(x, w, b=None, *, activation="silu", lb=128):
        return conv1d_ref(x, w, b, activation=activation)

    swaps = {"flash": (attention, "flash_attention", flash),
             "decode_mlp": (mlp, "decode_mlp", decode_mlp_ref),
             "conv1d": (mamba, "conv1d_fused", conv)}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in (swaps[w] for w in which)]
    try:
        for w in which:
            mod, name, fn = swaps[w]
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def recording(out: List):
    """Each layer's output x (f32, on the host) appended to `out`, layer by
    layer, call by call (prefill, then each decode step)."""
    from repro_torch.models import blocks

    full, step = blocks.apply_layer, blocks.apply_layer_decode

    def rec_full(*a, **k):
        r = full(*a, **k)
        out.append(r[0].float().cpu())
        return r

    def rec_step(*a, **k):
        r = step(*a, **k)
        out.append(r[0].float().cpu())
        return r

    blocks.apply_layer, blocks.apply_layer_decode = rec_full, rec_step
    try:
        yield
    finally:
        blocks.apply_layer, blocks.apply_layer_decode = full, step


def wave(cfg, seed: int = 1) -> np.ndarray:
    """Two prompts (600 and 40 tokens, left-padded to 600), drawn from
    `seed`."""
    gen = np.random.default_rng(seed)
    toks = np.zeros((len(PROMPTS), max(PROMPTS)), np.int64)
    for i, n in enumerate(PROMPTS):
        toks[i, max(PROMPTS) - n:] = gen.integers(1, cfg.vocab_size, size=n)
    return toks


def logits_run(model, toks: np.ndarray, forced: np.ndarray, layers: Optional[List] = None):
    """Prefill, then one decode step per row of `forced`: the logits
    (steps + 1, B, V) in f32 on the host."""
    from repro_torch.models import lm_decode_step, lm_prefill

    dev = model.device
    with torch.inference_mode(), (recording(layers) if layers is not None
                                  else contextlib.nullcontext()):
        logits, state = lm_prefill(model, torch.from_numpy(toks).to(dev), MAX_LEN)
        out = [logits.float().cpu()]
        for t, cur in enumerate(forced):
            logits, state = lm_decode_step(model, torch.from_numpy(cur).to(dev),
                                           toks.shape[1] + t, state)
            out.append(logits.float().cpu())
    return torch.stack(out)


def rel(a: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    """max |a - b| over max |b|, at the prefill and the worst decode step."""
    scale = float(b.abs().max())
    errs = [float((a[i] - b[i]).abs().max()) / scale for i in range(len(a))]
    return {"prefill": errs[0], "decode": max(errs[1:]), "steps": errs}


def layer_rel(a: List[torch.Tensor], b: List[torch.Tensor], n_layers: int) -> List[List[float]]:
    """Per call (prefill, steps), each layer's output error against b's,
    relative to b's max |x| at that layer."""
    rows = []
    for c in range(0, len(b), n_layers):
        rows.append([float((a[i] - b[i]).abs().max() / b[i].abs().max())
                     for i in range(c, c + n_layers)])
    return rows


def _copy(model, device, dtype=None):
    import copy

    from repro_torch.models.lm import LM

    memo = {id(p): torch.nn.Parameter(
        p.detach().to(device=device, dtype=dtype if dtype and p.dtype == torch.bfloat16
                      else p.dtype), requires_grad=False) for p in model.parameters()}
    out = copy.deepcopy(model, memo)
    if dtype is not None:
        out.cfg = dataclasses.replace(model.cfg, dtype="float32")  # f32 caches too
    assert isinstance(out, LM)
    return out


def cut_config(arch: str, n_layers: int, shared_period: int = 0, reduced: bool = False):
    """`arch` in bf16, cut to `n_layers` (and a shared-attention period,
    when given), at its reduced widths when `reduced`."""
    from repro_torch.configs import get_arch

    base = get_arch(arch).reduced() if reduced else get_arch(arch)
    changes = {"n_layers": n_layers, "dtype": "bfloat16"}  # reduced() widens to f32
    if shared_period:
        changes["shared_attn_period"] = shared_period
    return dataclasses.replace(base, **changes)


def drift(cfg, seed: int, steps: int, cpu_only: bool, layers: bool, exact: bool) -> Dict:
    """Every variant of one seed's weights (module docstring), each pair's
    logits errors, and with `layers` each layer's output errors."""
    from repro_torch.models import init_lm

    cpu = init_lm(cfg, seed=seed, device="cpu")
    toks = wave(cfg)
    forced = np.random.default_rng(seed + 100).integers(
        1, cfg.vocab_size, size=(steps, len(PROMPTS)))
    n_calls_layers = len(cpu.specs)
    runs, rec = {}, {}

    def go(name, model, ctx=contextlib.nullcontext(), keep=False):
        lay = [] if (layers and keep) else None
        with ctx:
            runs[name] = logits_run(model, toks, forced, lay)
        if lay is not None:
            rec[name] = lay

    go("cpu", cpu, keep=True)
    go("cpu_f32", _copy(cpu, "cpu", torch.float32), keep=True)
    if exact:
        with plain_kernels():
            go("cpu_exact", cpu, ExactProducts(), keep=True)
    if not cpu_only:
        card = _copy(cpu, "cuda")
        go("card", card, keep=True)
        with plain_kernels():
            go("card_plain", card)
        for k in KERNELS:
            with plain_kernels((k,)):
                go(f"card_plain_{k}", card)
        if exact:
            with plain_kernels():
                go("card_exact", card, ExactProducts(), keep=True)
        go("card_f32", _copy(cpu, "cuda", torch.float32))
        del card
        torch.cuda.empty_cache()
    out = {"arch": cfg.name, "seed": seed, "layers": [s.mixer for s in cpu.specs],
           "pairs": {}, "layer_rel": {}}
    for a, b in PAIRS:
        if a in runs and b in runs:
            r = rel(runs[a], runs[b])
            out["pairs"][f"{a} vs {b}"] = r
            print(f"  {a} vs {b}: prefill {r['prefill']:.3e}, decode max {r['decode']:.3e}, "
                  f"steps {' '.join('%.2e' % e for e in r['steps'])}", flush=True)
    for a, b in (("card", "cpu"), ("card", "card_exact"), ("cpu", "cpu_exact"),
                 ("card_exact", "cpu_exact"), ("cpu", "cpu_f32")):
        if a in rec and b in rec:
            rows = layer_rel(rec[a], rec[b], n_calls_layers)
            out["layer_rel"][f"{a} vs {b}"] = rows
            print(f"  layers {a} vs {b} ({', '.join(out['layers'])}): prefill "
                  f"{' '.join('%.2e' % e for e in rows[0])}; last step "
                  f"{' '.join('%.2e' % e for e in rows[-1])}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--shared-period", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--exact-seeds", type=int, default=1,
                    help="how many of the seeds also run the exact-product variants")
    ap.add_argument("--reduced", action="store_true", help="the config's reduced widths")
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.cpu_only:
        if not torch.cuda.is_available():
            print("bf16_drift: no card (pass --cpu-only for the CPU variants)")
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cut_config(args.arch, args.layers, args.shared_period, args.reduced)
    res = []
    for i, seed in enumerate(args.seeds):
        print(f"bf16_drift {args.arch} cut to {args.layers} layers, shared period "
              f"{args.shared_period or 'as registered'}, weights seed {seed}:", flush=True)
        res.append(drift(cfg, seed, args.steps, args.cpu_only, layers=i == 0,
                         exact=i < args.exact_seeds))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
