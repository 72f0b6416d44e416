"""The port in bf16, every registered config's own dtype, against the JAX
reference in bf16 on the CPU.

The reference builds its full-size models in bf16 and runs at its default
flags here (`flash_p_dtype` bf16, which `tests/conftest.py` turns to f32
for the session: flash rounds the softmax numerator P to bf16 before
P.V).  The same seeded numpy inputs -- bf16 arrays -- go
through both packages: `from_jax` (bit for bit), each module the serving
path runs, the plain versions of the three kernels against the
reference's Pallas kernels in interpret mode, and every registered
architecture, reduced and in bf16, end to end (logits, then a prefill and
8 teacher-forced decode steps; and logits against the reference's
default jnp path as it runs by itself, `DEFAULT_PATH_TOL`).

Tolerances: rel 1e-2 (max abs error over max |ref|) for a module or a
kernel -- both sides round to bf16 (eps 2^-8) at the same cast points but
sum in other orders, so a value rounds to the neighbouring bf16 now and
then (one ulp is 2^-8 relative); 2e-2 for logits through a whole stack,
where those ulps accumulate layer by layer (the reference's own bf16-P
tolerance in `tests/test_torch_lm.py`).  f32 results computed from the
same bf16 values (the loss, the MoE aux losses) are held at rel 1e-5.

The reference runs as the port runs it (`_reference`):
  - eagerly (`jax.disable_jit`), so that it rounds where its source casts:
    under jit XLA keeps excess precision in fused bf16 chains
    (`xla_allow_excess_precision`, on by default) and rounds wherever its
    fusions fall;
  - its SiLU evaluated in f32 and rounded once (`_silu_f32`), as the
    port's `F.silu` and the reference's Pallas kernels compute it: XLA's
    CPU backend evaluates a bf16 logistic at bf16 precision, up to two
    bf16 ulps off the correctly rounded SiLU
    (`test_reference_silu_is_within_two_ulps`);
  - its einsums of bf16 operands summed in f32 (`preferred_element_type`)
    on f32 copies of the operands (`_einsum_f32`; a bf16 product is exact
    in f32): XLA's CPU dot thunk refuses some of them (the absorbed MLA
    decode's `bhqs,bsr->bqhr` at Sq 1);
  - its mamba conv and its decode step's dense MLP through its Pallas
    kernels (`use_pallas_conv`; `_decode_mlp_pallas`), as the port's
    layers run theirs: the kernels keep the conv's chain and the MLP's h
    in f32, where the reference's jnp defaults round to bf16 after every
    multiply, add and activation.
"""

import contextlib
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs
from repro.kernels.conv1d_fused import conv1d_fused as jax_conv1d_fused
from repro.kernels.decode_mlp import decode_mlp as jax_decode_mlp
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import flash_attention as jax_flash
from repro.models import init_lm as jax_init_lm
from repro.models import lm_decode_step as jax_decode_step
from repro.models import lm_logits as jax_lm_logits
from repro.models import lm_prefill as jax_prefill
from repro.models import mamba as jax_mamba
from repro.models import mlp as jax_mlp
from repro.models import moe as jax_moe
from repro.models.runtime_flags import overrides
from repro_torch.configs import get_arch
from repro_torch.kernels.conv1d_fused import conv1d_fused
from repro_torch.kernels.decode_mlp import decode_mlp
from repro_torch.kernels.flash_attention import flash_attention as kernel_flash
from repro_torch.models import attention as attn
from repro_torch.models import common, from_jax, init_lm, lm_decode_step, lm_logits, lm_prefill
from repro_torch.models import mamba, mlp, moe
from repro_torch.models.flash_attention import flash_attention
from repro_torch.serve import Engine, ServeConfig

from _torch_params import nontrivial  # the seeded constant-drawn leaves

BF16 = jnp.bfloat16  # numpy's (ml_dtypes') bfloat16
MODULE_TOL = 1e-2
LOGITS_TOL = 2e-2
F32_TOL = 1e-5
ARCHS = tuple(list_archs())


def _cfgs(name: str):
    """(reference config, port config): `name` reduced, in bf16."""
    return (dataclasses.replace(jax_get_arch(name).reduced(), dtype="bfloat16"),
            dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16"))


def _t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of its dtype, bf16 bit for bit."""
    a = np.array(a, copy=True, order="C")
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(node):
    return {k: _tree(v) for k, v in node.items()} if isinstance(node, dict) else _t(node)


def _f64(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.detach().double().numpy()
    return np.asarray(y).astype(np.float64)


def _rel(y, ref) -> float:
    y, ref = _f64(y), _f64(ref)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _bf16(rng, shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(BF16)


def _silu_f32(x):
    """SiLU evaluated in f32 and rounded once to x's dtype."""
    x = jnp.asarray(x)
    xf = x.astype(jnp.float32)
    return (xf * jax.lax.logistic(xf)).astype(x.dtype)


def _einsum_f32(einsum):
    """`einsum`, with bf16 operands summed in f32 computed on f32 copies."""

    def f(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if jnp.asarray(o).dtype == BF16 else o for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    return f


def _decode_mlp_pallas(mlp_forward):
    """`mlp_forward`, with a decode step's (B, 1, D) through the reference's
    Pallas decode-MLP kernel."""

    def f(p, x):
        if x.shape[1] != 1:
            return mlp_forward(p, x)
        b, _, d = x.shape
        return jax_decode_mlp(x.reshape(b, d), p["w1"], p["w3"], p["w2"]).reshape(b, 1, d)

    return f


@contextlib.contextmanager
def _reference(eager: bool = True):
    """The reference as the port runs it (module docstring), at its default
    bf16 P (the test session's conftest sets f32).  `eager` False leaves
    jit on, for a caller that compiles with XLA's excess precision off
    (`test_torch_train_bf16.compiled`)."""
    saved = (jax_mamba.mamba_forward, jax_mlp.mlp_forward, jax.nn.silu, jnp.einsum)
    jax_mamba.mamba_forward = functools.partial(saved[0], use_pallas_conv=True)
    jax_mlp.mlp_forward = _decode_mlp_pallas(saved[1])
    jax.nn.silu = _silu_f32
    jnp.einsum = _einsum_f32(saved[3])
    try:
        with jax.disable_jit(eager), overrides(flash_p_dtype="bfloat16"):
            yield
    finally:
        jax_mamba.mamba_forward, jax_mlp.mlp_forward, jax.nn.silu, jnp.einsum = saved


def _pos(b: int, s: int, start: int = 0) -> np.ndarray:
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s)).copy()


# ------------------------------------------------------------ from_jax


def _leaf_digests_jax(node, stacked=False, out=None):
    """(dtype, shape, sha256 of the bytes) of every leaf of the reference's
    tree, a stacked group's leaves split along their repeat axis (the
    port's one tree per layer)."""
    out = [] if out is None else out
    if isinstance(node, dict):
        for k, v in node.items():
            _leaf_digests_jax(v, stacked or k == "layers", out)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _leaf_digests_jax(v, stacked, out)
    else:
        a = np.asarray(node)
        for piece in (a if stacked else [a]):
            piece = np.ascontiguousarray(piece)
            out.append((piece.dtype.name, piece.shape, hashlib.sha256(piece.tobytes()).hexdigest()))
    return out


def _leaf_digests_port(model) -> list:
    out = []
    for p in model.parameters():
        a = p.detach().contiguous()
        raw = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        out.append((str(a.dtype).removeprefix("torch."), tuple(a.shape),
                    hashlib.sha256(raw.tobytes()).hexdigest()))
    return out


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-7b",
                                  "deepseek-v3-671b", "seamless-m4t-medium"])
def test_from_jax_carries_a_bf16_tree_bit_for_bit(name):
    """Every leaf of the reference's bf16 tree arrives with its bits and
    dtype: bf16 leaves as torch.bfloat16, the f32 leaves of a bf16 tree (the
    MoE router, mamba's dt_bias, A_log and D) as float32."""
    jcfg, cfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    model = from_jax(params, cfg, device="cpu")
    want, have = _leaf_digests_jax(params), _leaf_digests_port(model)
    assert sorted(have) == sorted(want)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    f32 = {n for n, d in dtypes.items() if d == torch.float32}
    assert f32 == {n for n in dtypes if n.rsplit(".", 1)[-1] in ("router", "dt_bias", "A_log", "D")}
    assert f32 or name not in ("moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-7b",
                               "deepseek-v3-671b")
    assert all(d == torch.bfloat16 for n, d in dtypes.items() if n not in f32)


# ------------------------------------------------------------ common


def test_reference_silu_is_within_two_ulps():
    """XLA's bf16 SiLU on the CPU, which `_reference` replaces by the f32
    one, is at most two bf16 ulps from it."""
    x = _bf16(np.random.default_rng(15), (4096,), 2.0)
    with jax.disable_jit():
        xla = np.asarray(jax.nn.silu(jnp.asarray(x))).astype(np.float64)
    f32 = np.asarray(_silu_f32(x)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(f32), 1e-30))) - 7)
    assert (np.abs(xla - f32) <= 2 * ulp).all()
    y = torch.nn.functional.silu(_t(x)).double().numpy()
    np.testing.assert_array_equal(y, f32)  # the port's F.silu is the f32 one


def test_rms_norm_rotary_and_loss_in_bf16():
    """rms_norm in f32 back to x's dtype, rotary cos / sin in x's dtype,
    the loss in f32."""
    rng = np.random.default_rng(0)
    x, scale = _bf16(rng, (2, 9, 4, 16)), _bf16(rng, (16,), 0.1)
    pos = _pos(2, 9, 3)
    y = common.rms_norm(_t(x), _t(scale), 1e-6)
    assert y.dtype == torch.bfloat16
    assert _rel(y, jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)) < MODULE_TOL
    y = common.apply_rotary(_t(x), _t(pos), 10000.0)
    assert y.dtype == torch.bfloat16
    assert _rel(y, jax_common.apply_rotary(jnp.asarray(x), pos, 10000.0)) < MODULE_TOL
    logits, targets = _bf16(rng, (2, 9, 50), 3.0), rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.uniform(size=(2, 9)) < 0.7).astype(np.float32)
    loss = common.softmax_cross_entropy(_t(logits), _t(targets), _t(mask))
    ref = jax_common.softmax_cross_entropy(jnp.asarray(logits), targets, mask)
    assert loss.dtype == torch.float32 and _rel(loss, ref) < F32_TOL


# ------------------------------------------------------------ flash attention

FLASH_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, causal, window)
    "causal-gqa4": (2, 40, 40, 4, 1, 16, True, 0),
    "causal-window": (1, 45, 45, 4, 2, 32, True, 16),
    "bidirectional-encoder": (2, 33, 33, 4, 4, 16, False, 0),
    "cross-sq-ne-sk": (2, 20, 33, 4, 4, 16, False, 0),
    "cross-decode-sq1": (2, 1, 33, 4, 4, 16, False, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_model_flash_attention_in_bf16_matches_the_reference(case):
    """`models.flash_attention` at bf16 against the reference's model-level
    flash at its default bf16 P, in the model's (B, S, H, hd) layout."""
    b, sq, sk, hq, hkv, hd, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _bf16(rng, (b, sq, hq, hd)), _bf16(rng, (b, sk, hkv, hd)), _bf16(rng, (b, sk, hkv, hd))
    with _reference():
        ref = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        _pos(b, sq), _pos(b, sk), window=window, causal=causal,
                                        p_dtype=BF16)
    y = flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
                        causal=causal, window=window).transpose(1, 2)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    assert _rel(y, ref) < MODULE_TOL


def test_flash_attention_under_grad_in_bf16_on_the_cpu():
    """The plain forward and backward take bf16 on the CPU (the card
    refuses it until the backward kernel has its bf16 instantiation)."""
    rng = np.random.default_rng(2)
    q, k, v = (_t(_bf16(rng, (1, 4, 24, 16))).requires_grad_() for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    o.float().square().sum().backward()
    assert o.dtype == q.grad.dtype == torch.bfloat16
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


# ------------------------------------------------------------ attention


def _attn_case(name, init):
    jcfg, cfg = _cfgs(name)
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), jcfg, BF16))
    return jcfg, cfg, p, _tree(p)


def test_gqa_prefill_and_decode_in_bf16():
    """Prefill through flash, then a decode step over the bf16 cache (P cast
    to v's dtype), gemma3 reduced (qk-norm, a sliding window)."""
    jcfg, cfg, p, tp = _attn_case("gemma3-1b", jax_attn.init_attn)
    rng = np.random.default_rng(4)
    b, s, w = 2, 20, cfg.sliding_window
    x, x1 = _bf16(rng, (b, s, cfg.d_model)), _bf16(rng, (b, 1, cfg.d_model))
    for window in (0, w):
        with _reference():
            ref, (rk, rv) = jax_attn.attn_forward(p, jnp.asarray(x), _pos(b, s), jcfg,
                                                  window=window, return_kv=True)
        y, (k, v) = attn.attn_forward(tp, _t(x), _t(_pos(b, s)), cfg, window=window,
                                      return_kv=True)
        assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL
        rcache = jax_attn.fill_kv_cache(jax_attn.init_kv_cache(jcfg, b, 32, window, BF16),
                                        rk, rv, _pos(b, s))
        cache = attn.fill_kv_cache(attn.init_kv_cache(cfg, b, 32, window, torch.bfloat16, "cpu"),
                                   k, v, _t(_pos(b, s)))
        with _reference():
            ref, rcache = jax_attn.attn_decode(p, jnp.asarray(x1), s, rcache, jcfg, window=window)
        y, cache = attn.attn_decode(tp, _t(x1), s, cache, cfg, window=window)
        assert cache["k"].dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL
        assert _rel(cache["v"], rcache["v"]) < MODULE_TOL


def test_mla_prefill_and_absorbed_decode_in_bf16():
    """MLA's prefill through flash (q/k and v head dims apart) and its
    absorbed decode in the latent cache's dtype (deepseek-v3 reduced)."""
    jcfg, cfg, p, tp = _attn_case("deepseek-v3-671b", jax_attn.init_mla)
    rng = np.random.default_rng(5)
    b, s = 2, 18
    x, x1 = _bf16(rng, (b, s, cfg.d_model)), _bf16(rng, (b, 1, cfg.d_model))
    with _reference():
        ref, (rc, rr) = jax_attn.mla_forward(p, jnp.asarray(x), _pos(b, s), jcfg,
                                             return_latent=True)
    y, (c, r) = attn.mla_forward(tp, _t(x), _t(_pos(b, s)), cfg, return_latent=True)
    assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL
    rcache = jax_attn.fill_mla_cache(jax_attn.init_mla_cache(jcfg, b, 24, BF16), rc, rr,
                                     _pos(b, s))
    cache = attn.fill_mla_cache(attn.init_mla_cache(cfg, b, 24, torch.bfloat16, "cpu"), c, r,
                                _t(_pos(b, s)))
    with _reference():
        ref, _ = jax_attn.mla_decode(p, jnp.asarray(x1), s, rcache, jcfg)
    y, _ = attn.mla_decode(tp, _t(x1), s, cache, cfg)
    assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL


@pytest.mark.parametrize("sq", [20, 1])
def test_cross_attention_in_bf16(sq):
    """Cross attention over an encoder's output, at a prefill's Sq and a
    decode step's (seamless-m4t-medium reduced)."""
    jcfg, cfg, p, tp = _attn_case("seamless-m4t-medium", jax_attn.init_attn)
    rng = np.random.default_rng(6)
    x, enc = _bf16(rng, (2, sq, cfg.d_model)), _bf16(rng, (2, 33, cfg.d_model))
    with _reference():
        ref = jax_attn.attn_forward(p, jnp.asarray(x), _pos(2, sq), jcfg,
                                    cross_x=jnp.asarray(enc), cross_pos=_pos(2, 33))
    y = attn.attn_forward(tp, _t(x), None, cfg, cross_x=_t(enc))
    assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL


# ------------------------------------------------------------ MLP


def test_mlp_prefill_and_decode_in_bf16():
    """The prefill MLP (plain matmuls) against the reference's
    `mlp_forward` in bf16, and the decode MLP (the fused kernel's plain
    version: f32 h, one output rounding) against its Pallas decode MLP
    (`_reference`)."""
    jcfg, cfg = _cfgs("gemma3-1b")
    p = jax.tree.map(np.asarray, jax_mlp.init_mlp(jax.random.PRNGKey(7), cfg.d_model, cfg.d_ff,
                                                  BF16))
    rng = np.random.default_rng(7)
    for shape, fn in (((2, 7, cfg.d_model), mlp.mlp_forward), ((3, 1, cfg.d_model), mlp.mlp_decode)):
        x = _bf16(rng, shape)
        y = fn(_tree(p), _t(x))
        with _reference():
            ref = jax_mlp.mlp_forward(p, jnp.asarray(x))
        assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL


# ------------------------------------------------------------ mamba


def test_mamba_prefill_state_and_decode_in_bf16():
    """The SSD in f32 with its state in f32, y back to x's dtype; the
    prefill's conv through the fused conv1d's plain version (f32 taps,
    bias and SiLU), against the reference's with its Pallas conv (module
    docstring); a decode step from the prefill's state."""
    jcfg, cfg = _cfgs("mamba2-1.3b")
    p = nontrivial(jax.tree.map(np.asarray, jax_mamba.init_mamba(jax.random.PRNGKey(8), jcfg,
                                                                 BF16)))
    rng = np.random.default_rng(8)
    x, x1 = _bf16(rng, (2, 37, cfg.d_model)), _bf16(rng, (2, 1, cfg.d_model))
    with _reference():
        ref, rstate = jax_mamba.mamba_forward(p, jnp.asarray(x), jcfg, return_state=True)
    y, state = mamba.mamba_forward(_tree(p), _t(x), cfg, return_state=True)
    assert y.dtype == state["conv"].dtype == torch.bfloat16 and state["ssm"].dtype == torch.float32
    assert _rel(y, ref) < MODULE_TOL
    assert _rel(state["ssm"], rstate["ssm"]) < MODULE_TOL
    assert _rel(state["conv"], rstate["conv"]) < MODULE_TOL
    with _reference():
        ref, rstate = jax_mamba.mamba_decode(p, jnp.asarray(x1), rstate, jcfg)
    y, state = mamba.mamba_decode(_tree(p), _t(x1), state, cfg)
    assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL
    assert _rel(state["ssm"], rstate["ssm"]) < MODULE_TOL


# ------------------------------------------------------------ MoE


@pytest.mark.parametrize("s", [11, 1])
def test_moe_in_bf16(s):
    """Router and gates in f32; h and the expert outputs in x's dtype
    (moonshot reduced, at a prefill's and a decode step's shape)."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(9), jcfg, BF16))
    assert p["router"].dtype == np.float32
    x = _bf16(np.random.default_rng(9), (2, s, cfg.d_model))
    with _reference():
        ref, raux = jax_moe.moe_forward(p, jnp.asarray(x), jcfg)
    y, aux = moe.moe_forward(_tree(p), _t(x), cfg)
    assert y.dtype == torch.bfloat16 and _rel(y, ref) < MODULE_TOL
    for key in ("moe_aux", "moe_z"):
        assert aux[key].dtype == torch.float32 and _rel(aux[key], raux[key]) < F32_TOL


# ------------------------------------------------------------ the three kernels' plain versions


@pytest.mark.parametrize("case", ["causal-window", "noncausal", "gqa4"])
def test_plain_flash_kernel_in_bf16_matches_the_pallas_kernel(case):
    b, hq, hkv, sq, sk, hd, causal, window = {
        "causal-window": (2, 4, 1, 150, 150, 16, True, 40),
        "noncausal": (1, 4, 2, 70, 128, 32, False, 0),
        "gqa4": (1, 4, 1, 130, 130, 64, True, 0),
    }[case]
    rng = np.random.default_rng(10)
    q, k, v = _bf16(rng, (b, hq, sq, hd)), _bf16(rng, (b, hkv, sk, hd)), _bf16(rng, (b, hkv, sk, hd))
    ref = flash_attention_pallas(q, k, v, causal=causal, window=window)
    y = kernel_flash(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert ref.dtype == BF16 and y.dtype == torch.bfloat16
    assert _rel(y, ref) < MODULE_TOL


@pytest.mark.parametrize("b,d,f", [(4, 64, 96), (11, 32, 704), (1, 16, 40)])
def test_plain_decode_mlp_in_bf16_matches_the_pallas_kernel(b, d, f):
    rng = np.random.default_rng(11)
    x, w1, w3 = _bf16(rng, (b, d)), _bf16(rng, (d, f), d ** -0.5), _bf16(rng, (d, f), d ** -0.5)
    w2 = _bf16(rng, (f, d), f ** -0.5)
    ref = jax_decode_mlp(x, w1, w3, w2)
    y = decode_mlp(_t(x), _t(w1), _t(w3), _t(w2))
    assert ref.dtype == BF16 and y.dtype == torch.bfloat16
    assert _rel(y, ref) < MODULE_TOL


@pytest.mark.parametrize("k,act,length", [
    pytest.param(4, "silu", 64, id="4-silu"), pytest.param(3, "none", 64, id="3-none"),
    pytest.param(9, "silu", 64, id="9-silu"),
    # the lengths the bf16 stream treats as edges: one row, fewer rows than
    # K-1 (every window reaches into the causal pad), a length off its
    # 16-row chunks
    pytest.param(4, "silu", 1, id="4-silu-L1"), pytest.param(4, "silu", 2, id="4-silu-L2"),
    pytest.param(8, "none", 2, id="8-none-L2"), pytest.param(4, "silu", 47, id="4-silu-L47"),
])
def test_plain_conv1d_in_bf16_matches_the_pallas_kernel(k, act, length):
    rng = np.random.default_rng(12)
    x, w, bias = _bf16(rng, (2, length, 24)), _bf16(rng, (k, 24), 0.5), _bf16(rng, (24,), 0.1)
    ref = jax_conv1d_fused(x, w, bias, activation=act, lb=32)
    y = conv1d_fused(_t(x), _t(w), _t(bias), activation=act)
    assert ref.dtype == BF16 and y.dtype == torch.bfloat16
    assert _rel(y, ref) < MODULE_TOL


# ------------------------------------------------------------ every registered config


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(name, jax cfg, jax params, port model, source embeddings or None)
    for an arch reduced and in bf16."""
    name = request.param
    jcfg, cfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    if name == "zamba2-7b":
        params = nontrivial(params)
    src = (_bf16(np.random.default_rng(13), (2, 19, cfg.d_model))
           if cfg.is_encoder_decoder else None)
    return name, jcfg, params, from_jax(params, cfg, device="cpu"), src


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_lm_logits_in_bf16_match_the_reference(pair):
    name, jcfg, params, model, src = pair
    toks = _tokens(jcfg, (2, 24))
    kw = {} if src is None else {"src_embeds": jnp.asarray(src)}
    with _reference():
        ref = jax_lm_logits(params, jcfg, jnp.asarray(toks), **kw)
    y = lm_logits(model, torch.from_numpy(toks).long(),
                  **({} if src is None else {"src_embeds": _t(src)}))
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    assert _rel(y, ref) < LOGITS_TOL, name


# The reference's default jnp path rounds where the Pallas kernels do not
# (h after every multiply, add and SiLU of a dense MLP and of mamba's conv;
# its SiLU at bf16 precision on XLA's CPU backend); the port follows the
# kernels (`_reference`).  The two reference paths part by up to 0.117 of
# max |logits| here (moonshot-v1-16b-a3b, where a token's top-k expert
# choice flips between them; zamba2-7b 0.073; every other arch 0.012-0.028).
DEFAULT_PATH_TOL = 0.15


def test_lm_logits_in_bf16_against_the_reference_default_path(pair):
    """The port against the reference as it runs by itself (no patch, its
    default bf16 P): no further from it than the reference's own
    kernel-rounding path is, plus the logits tolerance, and within
    DEFAULT_PATH_TOL."""
    name, jcfg, params, model, src = pair
    toks = _tokens(jcfg, (2, 24))
    kw = {} if src is None else {"src_embeds": jnp.asarray(src)}
    with overrides(flash_p_dtype="bfloat16"):
        ref = jax_lm_logits(params, jcfg, jnp.asarray(toks), **kw)
    with _reference():
        kernels = jax_lm_logits(params, jcfg, jnp.asarray(toks), **kw)
    y = lm_logits(model, torch.from_numpy(toks).long(),
                  **({} if src is None else {"src_embeds": _t(src)}))
    port, own = _rel(y, ref), _rel(kernels, ref)
    assert port <= own + LOGITS_TOL and port < DEFAULT_PATH_TOL, (name, port, own)


def test_teacher_forced_decode_in_bf16_matches_the_reference(pair):
    """A 16-token prefill into bf16 caches (the config's dtype), then 8
    decode steps fed the same tokens on both sides."""
    name, jcfg, params, model, src = pair
    toks = _tokens(jcfg, (2, 24), seed=1)
    kw = {} if src is None else {"src_embeds": jnp.asarray(src)}
    with _reference():
        ref, rstate = jax_prefill(params, jcfg, jnp.asarray(toks[:, :16]), 40, **kw)
    y, state = lm_prefill(model, torch.from_numpy(toks[:, :16]).long(), 40,
                          **({} if src is None else {"src_embeds": _t(src)}))
    assert _rel(y, ref) < LOGITS_TOL, name
    for cache in state["layers"]:
        for key in set(cache) & {"k", "v", "c_kv", "k_rope", "conv"}:
            assert cache[key].dtype == torch.bfloat16, (name, key)
    for t in range(16, 24):
        with _reference():
            ref, rstate = jax_decode_step(params, jcfg, jnp.asarray(toks[:, t]), jnp.int32(t),
                                          rstate)
        y, state = lm_decode_step(model, torch.from_numpy(toks[:, t]).long(), t, state)
        assert y.dtype == torch.bfloat16 and _rel(y, ref) < LOGITS_TOL, (name, t)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("entry", ["lm_logits", "lm_prefill", "lm_decode_step"])
def test_serving_entry_points_sum_bf16_products_in_f32(entry, monkeypatch):
    """Inside each serving entry point cuBLAS may not reduce bf16 products
    in reduced precision, whatever the caller set; the caller's setting
    is back after the call."""
    from repro_torch.models import blocks

    _, cfg = _cfgs("gemma3-1b")
    model = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (2, 6))).long()
    _, state = lm_prefill(model, toks, 8)
    seen = []
    for fn in ("apply_layer", "apply_layer_decode"):
        def spy(*a, _f=getattr(blocks, fn), **k):
            seen.append(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
            return _f(*a, **k)
        monkeypatch.setattr(blocks, fn, spy)
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        if entry == "lm_logits":
            lm_logits(model, toks)
        elif entry == "lm_prefill":
            lm_prefill(model, toks, 8)
        else:
            lm_decode_step(model, toks[:, -1], 6, state)
        assert mm.allow_bf16_reduced_precision_reduction is True
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    assert seen and not any(seen), seen


def test_engine_samples_bf16_logits():
    """Greedy takes the argmax of the bf16 logits as they are; at a
    temperature the bf16 softmax is drawn from after its float64 copy is
    renormalised (numpy refuses the bf16 sum, ~1e-4 off 1)."""
    _, cfg = _cfgs("gemma3-1b")
    model = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(14)
    logits = _t(_bf16(rng, (3, 4096), 3.0))
    greedy = Engine(model, ServeConfig(temperature=0.0))._sample(logits, rng)
    np.testing.assert_array_equal(greedy, logits.float().argmax(-1).numpy())
    toks = Engine(model, ServeConfig(temperature=0.8))._sample(logits, np.random.default_rng(0))
    assert toks.shape == (3,) and ((0 <= toks) & (toks < 4096)).all()
