"""`repro_torch.serve.bf16_drift`, the tool that shows where a bf16 model's
card and CPU runs part, on the CPU at a reduced size: its exact-product
mode rounds each product once from float64, its kernel swap puts the
wrappers back, and a CPU-only run reports every pair and layer it can."""

import json

import numpy as np
import torch

from repro_torch.models import attention, mamba, mlp
from repro_torch.serve import bf16_drift


def test_exact_products_round_each_product_once_from_float64():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 96, generator=gen).bfloat16()
    b = torch.randn(96, 40, generator=gen).bfloat16()
    c = torch.randn(3, 40, 7, generator=gen).bfloat16()
    with bf16_drift.ExactProducts():
        mm = a @ b
        es = torch.einsum("bsk,kn->bsn", a, b)
        bm = torch.bmm(mm, c)
        f32 = a.float() @ b.float()
    want = (a.double() @ b.double()).bfloat16()
    assert mm.dtype == es.dtype == bm.dtype == torch.bfloat16 and f32.dtype == torch.float32
    assert torch.equal(mm, want) and torch.equal(es, want)
    assert torch.equal(bm, torch.bmm(want.double(), c.double()).bfloat16())
    assert torch.equal(f32, (a.double() @ b.double()).float())


def test_plain_kernels_swaps_the_wrappers_and_puts_them_back():
    before = (attention.flash_attention, mlp.decode_mlp, mamba.conv1d_fused)
    with bf16_drift.plain_kernels(("decode_mlp",)):
        assert mlp.decode_mlp is not before[1]
        assert (attention.flash_attention, mamba.conv1d_fused) == (before[0], before[2])
    with bf16_drift.plain_kernels():
        assert all(f is not g for f, g in zip(
            (attention.flash_attention, mlp.decode_mlp, mamba.conv1d_fused), before))
    assert (attention.flash_attention, mlp.decode_mlp, mamba.conv1d_fused) == before


def test_cpu_only_run_reports_pairs_and_layers(tmp_path):
    out = tmp_path / "drift.json"
    rc = bf16_drift.main(["--arch", "zamba2-7b", "--layers", "2", "--shared-period", "1",
                          "--reduced", "--cpu-only", "--seeds", "0", "--steps", "2",
                          "--out", str(out)])
    assert rc == 0
    (res,) = json.loads(out.read_text())
    assert res["layers"] == ["shared_attn", "mamba", "shared_attn", "mamba"]
    assert set(res["pairs"]) == {"cpu vs cpu_f32", "cpu vs cpu_exact"}
    for pair in res["pairs"].values():
        assert len(pair["steps"]) == 3 and np.isfinite(pair["steps"]).all()
    rows = res["layer_rel"]["cpu vs cpu_f32"]
    assert len(rows) == 3 and all(len(r) == 4 for r in rows)
    # bf16 against f32 of the same weights: apart, but within a few ulps
    assert 0 < res["pairs"]["cpu vs cpu_f32"]["prefill"] < 0.1
