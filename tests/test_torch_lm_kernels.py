"""The port's LM kernels' plain versions against the JAX reference.

On the CPU each entry point (`conv1d_fused`, `flash_attention`,
`decode_mlp`) runs its kernel's plain version; the same seeded numpy
inputs go through the reference's Pallas kernels in interpret mode and
its jnp oracles.  Tolerance: rel 1e-5 (max abs error over max |ref|), both
sides f32 with different summation orders.  The CUDA kernels themselves
are held against these plain versions on the card
(`tests/test_torch_kernel_cuda.py`, `chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as jax_analysis
from repro.core import registry as jax_registry
from repro.kernels.conv1d_fused import conv1d_fused as jax_conv1d_fused
from repro.kernels.conv1d_fused import conv1d_ref as jax_conv1d_ref
from repro.kernels.decode_mlp import decode_mlp as jax_decode_mlp
from repro.kernels.decode_mlp import decode_mlp_ref as jax_decode_mlp_ref
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.core import analysis, registry
from repro_torch.core.conv import conv1d_depthwise_causal
from repro_torch.kernels.conv1d_fused import conv1d_fused
from repro_torch.kernels.decode_mlp import decode_mlp
from repro_torch.kernels.flash_attention import flash_attention

REL_TOL = 1e-5


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------- conv1d

CONV_CASES = {
    # name: (B, L, D, K, lb, activation)
    "mamba-like-silu": (2, 64, 24, 4, 128, "silu"),
    "L-not-multiple-of-lb-none": (2, 100, 24, 4, 32, "none"),
    "short-K3-silu": (3, 5, 16, 3, 128, "silu"),
    "three-blocks-K2-none": (1, 300, 8, 2, 128, "none"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv1d_fused_matches_reference(case):
    b, length, d, k, lb, act = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, length, d)).astype(np.float32)
    w = (rng.standard_normal((k, d)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    y = conv1d_fused(_t(x), _t(w), _t(bias), activation=act, lb=lb).numpy()
    ref_pallas = np.asarray(jax_conv1d_fused(x, w, bias, activation=act, lb=lb))
    ref_jnp = np.asarray(jax_conv1d_ref(x, w, bias, activation=act))
    assert y.shape == ref_pallas.shape == (b, length, d)
    assert _rel(y, ref_pallas) < REL_TOL
    assert _rel(y, ref_jnp) < REL_TOL


def test_conv1d_fused_reads_a_column_slice_in_place():
    """Mamba hands the conv its xBC columns of the in-projection: a
    strided view, which gives the same result as its contiguous copy."""
    rng = np.random.default_rng(1)
    wide = _t(rng.standard_normal((2, 40, 30)).astype(np.float32))
    w = _t((rng.standard_normal((4, 12)) * 0.5).astype(np.float32))
    bias = _t(np.zeros(12, np.float32))
    view = wide[..., 10:22]
    ref = np.asarray(jax_conv1d_ref(view.numpy(), w.numpy(), bias.numpy()))
    assert _rel(conv1d_fused(view, w, bias).numpy(), ref) < REL_TOL


def test_conv1d_depthwise_causal_is_the_plain_conv():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 33, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    ref = np.asarray(jax_conv1d_ref(x, w, np.zeros(8, np.float32), activation="none"))
    assert _rel(conv1d_depthwise_causal(_t(x), _t(w)).numpy(), ref) < REL_TOL


def test_temporal_spec_plans_conv1d_fused_and_matches_lax():
    """The counterpart of the reference's registry test: a depthwise-causal
    temporal spec auto-plans onto the registered conv1d_fused algorithm,
    every 2-D algorithm declines it, and the result matches lax's grouped
    causal convolution and the reference registry's own execution."""
    b, length, d, k = 2, 64, 8, 4
    spec = registry.ConvSpec(h=1, w=length, c_in=d, c_out=d, k=k, pad=k - 1,
                             stride=1, groups=d)
    assert spec.temporal and spec.out_hw == (1, length)
    for name in ("direct", "l3_fused", "three_stage", "fft_fused"):
        assert not registry.get(name).supports(spec)
    ap = registry.plan_conv(spec, analysis.SKYLAKE_X)
    assert ap.algo == "conv1d_fused"

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, 1, length, d)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((1, k, 1, d)) * 0.1).astype(np.float32)
    y = registry.get(ap.algo).execute(_t(x), _t(w), None, ap).numpy()
    ref = np.asarray(jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding=((0, 0), (k - 1, 0)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=d,
    ))
    jspec = jax_registry.ConvSpec(h=1, w=length, c_in=d, c_out=d, k=k,
                                  pad=k - 1, stride=1, groups=d)
    jap = jax_registry.plan_conv(jspec, jax_analysis.SKYLAKE_X)
    ref_reg = np.asarray(jax_registry.get(jap.algo).execute(x, w, None, jap))
    assert jap.algo == ap.algo and ap.params == jap.params
    assert y.shape == ref.shape == (b, 1, length, d)
    np.testing.assert_allclose(y, ref, atol=1e-5)
    assert _rel(y, ref_reg) < REL_TOL


# ------------------------------------------------------ flash attention

FLASH_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, hd, causal, window)
    "gqa4-window-ragged": (2, 4, 1, 150, 150, 16, True, 40),
    "gqa1-global-ragged": (1, 2, 2, 130, 130, 32, True, 0),
    "gqa2-noncausal-sk-multiple": (1, 4, 2, 70, 128, 16, False, 0),
    "causal-sq-lt-sk-ragged": (1, 4, 1, 50, 140, 16, True, 0),
    "window-1": (1, 2, 1, 20, 20, 8, True, 1),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    b, hq, hkv, sq, sk, hd, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, hq, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, hd)).astype(np.float32)
    y = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    ref_pallas = np.asarray(flash_attention_pallas(q, k, v, causal=causal, window=window))
    ref_jnp = np.asarray(jax_attention_ref(q, k, v, causal=causal, window=window))
    assert y.shape == ref_pallas.shape == (b, hq, sq, hd)
    assert _rel(y, ref_pallas) < REL_TOL
    assert _rel(y, ref_jnp) < REL_TOL


def test_flash_attention_model_layout_view():
    """The model passes (B, H, S, hd) transposes of its (B, S, H, hd)
    activations; the result is the contiguous inputs' result."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((2, 37, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((2, 37, 1, 16)).astype(np.float32))
    v = _t(rng.standard_normal((2, 37, 1, 16)).astype(np.float32))
    y = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=9)
    ref = np.asarray(jax_attention_ref(
        q.transpose(1, 2).numpy(), k.transpose(1, 2).numpy(),
        v.transpose(1, 2).numpy(), window=9,
    ))
    assert _rel(y.numpy(), ref) < REL_TOL


def test_flash_attention_noncausal_ragged_sk_raises_like_reference():
    q = np.zeros((1, 2, 8, 16), np.float32)
    kv = np.zeros((1, 2, 130, 16), np.float32)
    with pytest.raises(AssertionError):
        flash_attention_pallas(q, kv, kv, causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(_t(q), _t(kv), _t(kv), causal=False)


# ---------------------------------------------------------- decode MLP

MLP_CASES = {
    # name: (B, d, f): B and f need not be multiples of rb=8 / fb=512
    "gemma-like": (4, 64, 96),
    "b-and-f-ragged": (11, 32, 700),
    "single-row": (1, 16, 33),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_decode_mlp_matches_reference(case):
    b, d, f = MLP_CASES[case]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    y = decode_mlp(_t(x), _t(w1), _t(w3), _t(w2)).numpy()
    ref_pallas = np.asarray(jax_decode_mlp(x, w1, w3, w2))
    ref_jnp = np.asarray(jax_decode_mlp_ref(jnp.asarray(x), w1, w3, w2))
    assert y.shape == ref_pallas.shape == (b, d)
    assert _rel(y, ref_pallas) < REL_TOL
    assert _rel(y, ref_jnp) < REL_TOL
