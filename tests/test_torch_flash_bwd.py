"""The flash backward's plain version and the autograd function that
training runs, against the reference's custom VJP.

`flash_attention_bwd_ref` (fed the port's plain forward output and
`lse_ref`) and `lse_ref` are held against `jax.vjp` of the reference's
`flash_attention` (p_dtype f32) and its forward's lse, at the five cases
of `tests/test_flash_attention.py`, with that file's gradient tolerance:
abs 5e-5.  On the CPU, autograd through `FlashAttention` must equal the
plain backward exactly (it is the same function there) and agree with
autograd through the plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash_attention import _flash_fwd_impl
from repro.models.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd_ref, lse_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models.flash_attention import FlashAttention
from repro_torch.models.flash_attention import flash_attention as flash_grad

GRAD_ATOL = 5e-5  # tests/test_flash_attention.py's gradient tolerance
LSE_ATOL = 1e-5

CASES = [  # (b, s, hq, hkv, hd, window, q_blk, kv_blk, causal)
    (2, 64, 4, 2, 16, 0, 16, 16, True),
    (1, 48, 4, 1, 8, 12, 16, 8, True),
    (2, 60, 2, 2, 8, 0, 16, 16, True),  # padding path
    (1, 64, 4, 4, 8, 0, 32, 16, False),  # encoder
    (1, 96, 8, 2, 16, 20, 16, 16, True),  # banded window
]


def _inputs(seed, b, s, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    return q, k, v, do


def _bhsd(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).transpose(1, 2)  # (B, S, H, hd) -> (B, H, S, hd)


def _jax_lse(q, k, v, window, q_blk, kv_blk, causal):
    """The reference forward's lse, (B, Hq, S), with its wrapper's padding."""
    b, s, hq, _ = q.shape
    q_blk, kv_blk = min(q_blk, s), min(kv_blk, s)
    pad_q, pad_k = (-s) % q_blk, (-s) % kv_blk
    pos = np.broadcast_to(np.arange(s, dtype=np.float32), (b, s))
    qp = np.pad(pos, ((0, 0), (0, pad_q)), constant_values=2e9)
    kp = np.pad(pos, ((0, 0), (0, pad_k)), constant_values=-1.0)
    qq = np.pad(q, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
    kk = np.pad(k, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    vv = np.pad(v, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    _, lse, _ = _flash_fwd_impl(jnp.asarray(qq), jnp.asarray(kk), jnp.asarray(vv),
                                jnp.asarray(qp), jnp.asarray(kp), causal, window,
                                q_blk, kv_blk, jnp.float32)
    return np.asarray(lse).reshape(b, hq, -1)[:, :, :s]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}s{}hq{}hkv{}hd{}w{}c{}".format(
    *c[:6], int(c[8])))
def test_plain_backward_and_lse_match_the_reference_vjp(case):
    b, s, hq, hkv, hd, window, qb, kb, causal = case
    q, k, v, do = _inputs(1, b, s, hq, hkv, hd)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, pos, pos, window=window, causal=causal,
                         q_blk=qb, kv_blk=kb, p_dtype=jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    qt, kt, vt = _bhsd(q), _bhsd(k), _bhsd(v)
    o = attention_ref(qt, kt, vt, causal=causal, window=window)
    lse = lse_ref(qt, kt, causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, window, qb, kb, causal),
                               rtol=0, atol=LSE_ATOL)
    grads = flash_attention_bwd_ref(qt, kt, vt, o, lse, _bhsd(do), causal=causal, window=window)
    for name, g, r in zip("qkv", grads, ref):
        g = g.transpose(1, 2).numpy()
        assert g.shape == r.shape, name
        err = float(np.abs(g - r).max())
        assert err < GRAD_ATOL, (name, err)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
def test_autograd_through_flash_attention_equals_the_plain_backward(window, hq, hkv):
    q, k, v, do = _inputs(2, 2, 70, hq, hkv, 16)
    qt, kt, vt = (_bhsd(x).requires_grad_(True) for x in (q, k, v))
    o = flash_grad(qt, kt, vt, causal=True, window=window)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    o.backward(_bhsd(do))
    with torch.no_grad():
        lse = lse_ref(qt, kt, causal=True, window=window)
        want = flash_attention_bwd_ref(qt, kt, vt, o, lse, _bhsd(do), causal=True, window=window)
    for t, w in zip((qt, kt, vt), want):
        assert torch.equal(t.grad, w)

    # and autograd through the plain forward agrees (f32, other sum orders)
    q2, k2, v2 = (_bhsd(x).requires_grad_(True) for x in (q, k, v))
    attention_ref(q2, k2, v2, causal=True, window=window).backward(_bhsd(do))
    for t, t2 in zip((qt, kt, vt), (q2, k2, v2)):
        assert float((t.grad - t2.grad).abs().max()) < GRAD_ATOL


def test_flash_attention_under_grad_refuses_sq_other_than_sk():
    q = torch.zeros(1, 2, 8, 16, requires_grad=True)
    k = torch.zeros(1, 2, 12, 16, requires_grad=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_grad(q, k, k, causal=True)


def test_full_attention_goes_through_flash_attention_only_under_grad():
    q, k, v, _ = _inputs(3, 1, 20, 4, 1, 16)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = attn_mod.full_attention(qt, kt, vt, window=8)
    assert "FlashAttention" in type(out.grad_fn.next_functions[0][0]).__name__
    with torch.inference_mode():
        served = attn_mod.full_attention(qt, kt, vt, window=8)
    assert served.grad_fn is None
    assert torch.equal(served, out.detach())


def test_flash_attention_function_is_once_differentiable():
    q, k, v, _ = _inputs(4, 1, 12, 2, 2, 16)
    qt, kt, vt = (_bhsd(x).requires_grad_(True) for x in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, True, 0)
    (g,) = torch.autograd.grad(o.sum(), qt, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def test_refuse_grad_raises_only_for_an_input_that_needs_a_gradient():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no autograd backward.*ROADMAP"):
        _build.refuse_grad("conv1d_fused", "ROADMAP §1, mamba2 training", x)
    _build.refuse_grad("conv1d_fused", "ROADMAP §1, mamba2 training", x.detach())
    with torch.no_grad():
        _build.refuse_grad("conv1d_fused", "ROADMAP §1, mamba2 training", x)
