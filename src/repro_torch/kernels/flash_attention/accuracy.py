"""Where the flash kernel's error comes from: the kernel and its plain
version, each against a float64 evaluation of the same attention, on one
card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.accuracy \
        [--out build/flash_accuracy.json]

For each case (head dims 80, 112, 128 and 256, deepseek-v3-671b's MLA
at q/k hd 192 with v hd 128 and its MTP block's 56, the last two on
fresh fragments beside hd 80's, and seamless-m4t-medium's hd 64 over
1,024 unmasked keys -- its encoder and its cross attention --; causal
and non-causal; seeded N(0, 1) inputs) it prints the max abs error and the max rel error
(max abs error over max |reference|) against float64 of: the kernel; the
plain version (`attention_ref`, fp32 with TF32 off); and the kernel's
split-TF32 operands alone (each of q, k, P and v rounded to big + small
TF32 parts as the kernel rounds them, everything else in float64: the
error the operand split costs, before any fp32 accumulation).  Beside
them the kernel against the plain version -- the quantity the 1e-5 gate
of `chip_smoke.py` and the card tests reads -- max |output| and the
median over rows of sum_j p_j |v_j| / |o| (how much a row's output
cancels).  Rows go to `--out` as JSON with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention

CASES = [
    # (label, B, H, Sq, Sk, hd, vd, causal, window)
    ("hd112 S768 non-causal", 2, 32, 768, 768, 112, 112, False, 0),
    ("hd128 S768 non-causal", 2, 32, 768, 768, 128, 128, False, 0),
    ("hd80 S768 non-causal", 2, 32, 768, 768, 80, 80, False, 0),
    ("hd192/128 S768 non-causal", 2, 32, 768, 768, 192, 128, False, 0),
    ("hd56 S768 non-causal", 2, 32, 768, 768, 56, 56, False, 0),
    ("hd256 S768 non-causal", 2, 8, 768, 768, 256, 256, False, 0),
    ("hd64 S1024 non-causal", 2, 16, 1024, 1024, 64, 64, False, 0),
    ("hd64 Sq128 Sk1024 non-causal", 4, 16, 128, 1024, 64, 64, False, 0),
    ("hd112 S256 non-causal", 2, 32, 256, 256, 112, 112, False, 0),
    ("hd128 Sq77 Sk256 non-causal", 1, 2, 77, 256, 128, 128, False, 0),
    ("hd112 S768 causal w512", 2, 32, 768, 768, 112, 112, True, 512),
    ("hd80 S700 causal", 4, 32, 700, 700, 80, 80, True, 0),
    ("hd192/128 S700 causal", 4, 32, 700, 700, 192, 128, True, 0),
    ("hd56 S1023 causal", 4, 32, 1023, 1023, 56, 56, True, 0),
    ("hd256 S700 causal", 4, 4, 700, 700, 256, 256, True, 0),
]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 with round-to-nearest, ties away (`cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    big = _tf32(x)
    return big.double(), _tf32(x - big).double()


def _attention_f64(q, k, v, ok, hd, split: bool) -> torch.Tensor:
    """Attention in float64; with `split`, each product's operands are the
    kernel's big + small TF32 parts and the small.small term is dropped."""
    if split:
        (qb, qs), (kb, ks) = _split(q), _split(k)
        s = sum(torch.einsum("bhqd,bhkd->bhqk", a, b) for a, b in ((qs, kb), (qb, ks), (qb, kb)))
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    s = (s * hd ** -0.5).masked_fill(~ok, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(-1e300)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if split:
        (pb, ps), (vb, vs) = _split(p.float()), _split(v)
        o = sum(torch.einsum("bhqk,bhkd->bhqd", a, b) for a, b in ((ps, vb), (pb, vs), (pb, vb)))
    else:
        o = torch.einsum("bhqk,bhkd->bhqd", p, v.double())
    return o / l.clamp_min(1e-30)


def _err(y: torch.Tensor, ref: torch.Tensor) -> tuple:
    d = float((y.double() - ref).abs().max())
    return d, d / float(ref.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    rows = []
    for label, b, h, sq, sk, hd, vd, causal, window in CASES:
        q, k, v = (torch.tensor(gen.standard_normal(shape), dtype=torch.float32, device=dev)
                   for shape in ((b, h, sq, hd), (b, h, sk, hd), (b, h, sk, vd)))
        y = flash_attention(q, k, v, causal=causal, window=window)
        plain = attention_ref(q, k, v, causal=causal, window=window)
        qp = torch.arange(sq, device=dev)[:, None]
        kp = torch.arange(sk, device=dev)[None, :]
        ok = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= qp - kp < window
        f64 = _attention_f64(q, k, v, ok, hd, split=False)
        split = _attention_f64(q, k, v, ok, hd, split=True)
        # how much each row's output cancels: sum_j p_j |v_j| against |o|
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), -1)
        mass = torch.einsum("bhqk,bhkd->bhqd", p, v.double().abs())
        cancel = float((mass / f64.abs().clamp_min(1e-12)).median())
        row = dict(case=label, kernel_vs_f64=_err(y, f64), plain_vs_f64=_err(plain, f64),
                   split_operands_vs_f64=_err(split, f64),
                   kernel_vs_plain=_err(y, plain.double()),
                   max_abs_out=float(f64.abs().max()), median_mass_over_out=cancel)
        rows.append(row)
        print(f"{label:28s} rel vs f64: kernel {row['kernel_vs_f64'][1]:.3e}, plain "
              f"{row['plain_vs_f64'][1]:.3e}, split operands "
              f"{row['split_operands_vs_f64'][1]:.3e} | kernel vs plain "
              f"{row['kernel_vs_plain'][1]:.3e} | max|o| {row['max_abs_out']:.3f}, "
              f"median sum p|v| / |o| {cancel:.1f}")
        del q, k, v, y, plain, f64, split, s, p, mass
    card = _card()
    print(f"card: {card}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
