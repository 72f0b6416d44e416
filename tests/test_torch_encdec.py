"""The encoder-decoder (seamless-m4t-medium) in the port against JAX.

The reference's `init_lm` weights of reduced seamless-m4t-medium (2
bidirectional encoder layers and 4 decoder layers with cross attention,
d_model 64, 4 heads of 16, d_ff 96, vocab 256), loaded with `from_jax`,
go through both stacks on the CPU with the same seeded inputs: source
frame embeddings drawn standard normal with numpy, as the reference's
tests draw them, and seeded tokens.  Held: the leaves `from_jax` carries,
the init's distributions, cross attention and the encoder's
bidirectional self-attention, `_encode`, `lm_logits`, `lm_prefill` and
teacher-forced `lm_decode_step`s, `lm_loss` and every gradient leaf
(remat on and off), and `FlashAttention` at non-causal Sq != Sk against
`jax.grad` of the reference's `flash_attention`.  The reference runs
under ``overrides(flash_p_dtype="float32")``, as the port keeps P in f32.

Tolerances: outputs and logits rel 1e-4 (max abs error over max |ref|;
both sides f32, summed in other orders through up to 6 layers, observed
~1e-6), the loss rel 1e-5, every gradient leaf rel 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as jax_attn
from repro.models import init_lm as jax_init_lm
from repro.models import lm_decode_step as jax_decode_step
from repro.models import lm_logits as jax_lm_logits
from repro.models import lm_prefill as jax_prefill
from repro.models.blocks import build_stack_plan as jax_stack_plan
from repro.models.flash_attention import flash_attention as jax_flash
from repro.models.lm import _encode as jax_encode
from repro.models.lm import lm_loss as jax_lm_loss
from repro.models.runtime_flags import overrides
from repro_torch.configs import get_arch
from repro_torch.models import attention as attn_mod
from repro_torch.models import from_jax, init_lm, lm_decode_step, lm_logits, lm_loss, lm_prefill
from repro_torch.models.blocks import build_stack_plan
from repro_torch.models.common import Params
from repro_torch.models.flash_attention import flash_attention as flash_grad
from repro_torch.models.lm import _encode

NAME = "seamless-m4t-medium"
REL_TOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
TRUNC_STD = 0.8796  # the std of N(0, 1) truncated to [-2, 2]
SRC = 33  # source frames: not a multiple of any tile


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _src(cfg, b=2, s=SRC, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model) of reduced seamless-m4t-medium."""
    cfg = jax_get_arch(NAME).reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(NAME).reduced(), device="cpu")
    return cfg, params, model


def _leaf_names(params) -> dict:
    """The reference's leaves under the port's names: a stacked leaf
    `stack/g/layers/i/...` once per repeat r, as layer (g, r, i) of the
    flat stack (the encoder's under ``encoder.``)."""
    out = {}
    cfg = jax_get_arch(NAME).reduced()
    for prefix, tree, plan in (("", params, jax_stack_plan(cfg, "decoder")),
                               ("encoder.", params["encoder"], jax_stack_plan(cfg, "encoder"))):
        base = 0
        for gspec, group in zip(plan, tree["stack"]):
            for path, leaf in jax.tree_util.tree_flatten_with_path(group["layers"])[0]:
                i = path[0].idx
                rest = ".".join(str(k.key) for k in path[1:])
                for r in range(gspec.n_repeat):
                    out[f"{prefix}layers.{base + r * len(gspec.layers) + i}.{rest}"] = (
                        np.asarray(leaf[r]))
            base += gspec.n_repeat * len(gspec.layers)
        out[f"{prefix}final_norm"] = np.asarray(tree["final_norm"])
    for k in ("embed", "lm_head"):
        out[k] = np.asarray(params[k])
    return out


def test_reduced_config_and_plans_are_the_reference(pair):
    """The config equals the reference's field by field; the encoder is
    one group of bidirectional attention layers, the decoder's layers
    carry cross attention, as the reference's plans say."""
    for cfg, ref in ((get_arch(NAME), jax_get_arch(NAME)),
                     (get_arch(NAME).reduced(), jax_get_arch(NAME).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        for role in ("encoder", "decoder"):
            assert [(g.n_repeat, [dataclasses.asdict(s) for s in g.layers])
                    for g in build_stack_plan(cfg, role)] == [
                (g.n_repeat, [dataclasses.asdict(s) for s in g.layers])
                for g in jax_stack_plan(ref, role)]
    _, _, model = pair
    assert [(s.causal, s.cross_attn) for s in model.enc_specs] == [(False, False)] * 2
    assert [(s.causal, s.cross_attn) for s in model.specs] == [(True, True)] * 4


def test_from_jax_carries_every_reference_leaf(pair):
    """Every reference leaf, by name, shape and value; no other leaf."""
    _, params, model = pair
    want = _leaf_names(params)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert sum(np.size(x) for x in jax.tree.leaves(params)) == sum(x.size for x in got.values())
    for n, x in want.items():
        np.testing.assert_array_equal(got[n], x, err_msg=n)
    assert {n[len("layers.0."):] for n in got if n.startswith("layers.0.")} >= {
        "ln_cross", "cross.wq", "cross.wk", "cross.wv", "cross.wo"}


def test_init_lm_draws_the_reference_distributions():
    """The port's init has the reference's leaves and shapes; the
    encoder's and the cross attention's norms are zeros and their dense
    weights, scaled by sqrt(fan-in) and pooled, a normal truncated at 2
    std (std 0.8796) in both packages (at d_model 256, so the pool is
    large)."""
    wide = dict(d_model=256, d_ff=384, n_heads=4, n_kv_heads=4, head_dim=64)
    cfg = dataclasses.replace(get_arch(NAME).reduced(), **wide)
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(), **wide)
    model = init_lm(cfg, seed=0, device="cpu")
    ref = from_jax(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg)), cfg,
                   device="cpu")
    ours, theirs = dict(model.named_parameters()), dict(ref.named_parameters())
    assert {n: tuple(p.shape) for n, p in ours.items()} == {
        n: tuple(p.shape) for n, p in theirs.items()}
    picked = [n for n in ours if n.startswith("encoder.") or ".cross." in n or "ln_cross" in n]
    assert len(picked) == 2 * 9 + 1 + 4 * 5  # encoder layers, its final norm, 4 cross blocks
    for tree in (ours, theirs):
        pool = []
        for n in picked:
            w = tree[n].detach().numpy().astype(np.float64)
            if w.ndim == 1:
                assert not w.any(), n  # norms' scales are stored as zeros
            else:
                pool.append((w * np.sqrt(w.shape[0])).ravel())
        pool = np.concatenate(pool)
        assert abs(pool.std() / TRUNC_STD - 1) < 0.01
        assert np.abs(pool).max() <= 2 * (1 + 1e-6)


ATTN_CASES = {  # label: (Sq, Sk, cross)
    "cross-Sq20-Sk33": (20, SRC, True),
    "cross-decode-Sq1-Sk33": (1, SRC, True),
    "encoder-self-S33-bidirectional": (SRC, SRC, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_attn_forward_matches_jax(case):
    """Cross attention (k and v from the encoder's output, no rotary, no
    mask) and the encoder's bidirectional self-attention (rotary,
    non-causal) against the reference's `attn_forward`."""
    sq, sk, cross = ATTN_CASES[case]
    cfg = jax_get_arch(NAME).reduced()
    p = jax_attn.init_attn(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    cx = rng.standard_normal((2, sk, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq))
    cpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk))
    kw = dict(cross_x=jnp.asarray(cx), cross_pos=jnp.asarray(cpos)) if cross else dict(
        causal=False)
    with overrides(flash_p_dtype="float32"):
        ref = np.asarray(jax_attn.attn_forward(p, jnp.asarray(x), jnp.asarray(pos), cfg, **kw))
    tp = Params(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))
    mine = attn_mod.attn_forward(
        tp, torch.from_numpy(x), None if cross else torch.from_numpy(pos.copy()),
        get_arch(NAME).reduced(),
        **(dict(cross_x=torch.from_numpy(cx)) if cross else dict(causal=False)))
    assert tuple(mine.shape) == ref.shape == (2, sq, cfg.d_model)
    assert _rel(mine.numpy(), ref) < REL_TOL


def test_encode_matches_jax(pair):
    cfg, params, model = pair
    src = _src(cfg)
    with overrides(flash_p_dtype="float32"):
        ref_x, ref_pos = jax_encode(params, cfg, jnp.asarray(src))
    x, pos = _encode(model, torch.from_numpy(src))
    assert tuple(x.shape) == (2, SRC, cfg.d_model)
    assert _rel(x.detach().numpy(), ref_x) < REL_TOL
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))


def test_lm_logits_with_src_embeds_match_jax(pair):
    cfg, params, model = pair
    toks, src = _tokens(cfg, (2, 28)), _src(cfg, seed=1)
    with overrides(flash_p_dtype="float32"):
        ref = np.asarray(jax_lm_logits(params, cfg, jnp.asarray(toks),
                                       src_embeds=jnp.asarray(src)))
    y = lm_logits(model, torch.from_numpy(toks).long(), src_embeds=torch.from_numpy(src))
    assert y.shape == ref.shape == (2, 28, cfg.vocab_size)
    assert _rel(y.numpy(), ref) < REL_TOL


def test_an_encoder_decoder_needs_src_embeds(pair):
    _, _, model = pair
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: lm_logits(model, toks), lambda: lm_prefill(model, toks, 8),
                 lambda: lm_loss(model, {"tokens": toks, "targets": toks})):
        with pytest.raises(ValueError, match="src_embeds"):
            call()


def test_prefill_and_decode_match_jax(pair):
    """`lm_prefill` with `src_embeds` (the state's `cross_x`, `cross_pos`
    and layer 0's cache) and 4 teacher-forced `lm_decode_step`s against
    the reference's."""
    cfg, params, model = pair
    toks, src = _tokens(cfg, (2, 24), seed=2), _src(cfg, seed=2)
    forced = _tokens(cfg, (4, 2), seed=3)
    with overrides(flash_p_dtype="float32"):
        ref_logits, ref_state = jax_prefill(params, cfg, jnp.asarray(toks), 40,
                                            src_embeds=jnp.asarray(src))
        ref_prefill = ref_state
        ref_steps = []
        for t in range(4):
            lg, ref_state = jax_decode_step(params, cfg, jnp.asarray(forced[t]),
                                            jnp.int32(24 + t), ref_state)
            ref_steps.append(np.asarray(lg))
    logits, state = lm_prefill(model, torch.from_numpy(toks).long(), 40,
                               src_embeds=torch.from_numpy(src))
    assert _rel(logits.numpy(), ref_logits) < REL_TOL
    assert set(state) == {"layers", "cross_x", "cross_pos"}
    assert _rel(state["cross_x"].numpy(), ref_prefill["cross_x"]) < REL_TOL
    np.testing.assert_array_equal(state["cross_pos"].numpy(),
                                  np.asarray(ref_prefill["cross_pos"]))
    c0 = ref_prefill["groups"][0][0]["self"]
    np.testing.assert_allclose(state["layers"][0]["k"].numpy(), np.asarray(c0["k"][0]),
                               atol=1e-6)
    for t in range(4):
        logits, state = lm_decode_step(model, torch.from_numpy(forced[t]).long(), 24 + t, state)
        assert _rel(logits.numpy(), ref_steps[t]) < REL_TOL, t


def _batch(cfg, b=2, s=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, -3:] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask,
            "src_embeds": rng.standard_normal((b, SRC, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference_grads(pair):
    """(batch, loss, port model of the reference's gradients)."""
    cfg, params, _ = pair
    batch = _batch(cfg)
    with overrides(flash_p_dtype="float32"):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_lm_loss(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(params)
    g_model = from_jax(jax.tree.map(np.asarray, grads), get_arch(NAME).reduced(), device="cpu")
    return batch, float(loss), g_model


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_every_gradient_match_jax(pair, reference_grads, remat):
    """The loss (encoder without remat, decoder with or without) and every
    gradient leaf against `jax.value_and_grad` of the reference's
    `lm_loss`; the encoder's and the cross attention's leaves each take a
    non-zero gradient."""
    cfg, params, _ = pair
    batch, ref_loss, g_model = reference_grads
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(NAME).reduced(), device="cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v).long() if k in ("tokens", "targets") else torch.from_numpy(v)
          for k, v in batch.items()}
    loss, _ = lm_loss(model, tb, remat=remat)
    assert _rel(float(loss.detach()), ref_loss) < LOSS_REL
    names, ps = zip(*model.named_parameters())
    want = dict(g_model.named_parameters())
    assert set(names) == set(want)
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        ref = want[n].detach().numpy()
        assert _rel(g.numpy(), ref) < GRAD_REL, n
        if n.startswith("encoder.layers") or ".cross.w" in n:
            assert np.abs(ref).max() > 0 and g.abs().max() > 0, n


FLASH_CASES = {  # label: (B, Hq, Hkv, Sq, Sk, hd)
    "cross-Sq20-Sk33": (2, 4, 4, 20, 33, 16),
    "decode-Sq1-Sk40": (2, 4, 4, 1, 40, 16),
    "gqa-Sq48-Sk16": (1, 4, 2, 48, 16, 32),
}


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_attention_takes_non_causal_sq_other_than_sk(case):
    """`FlashAttention` (the plain forward and backward on the CPU) at
    non-causal Sq != Sk: the output and dq, dk, dv against `jax.grad` of
    the reference's `flash_attention` (whose mask there is kv_pos >= 0
    alone, so positions do not matter)."""
    b, hq, hkv, sq, sk, hd = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    qp = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32), (b, sq))
    kp = jnp.broadcast_to(jnp.arange(sk, dtype=jnp.int32), (b, sk))

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, qp, kp, causal=False, p_dtype=jnp.float32)

    ref_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
    o = flash_grad(*leaves, causal=False)
    assert "FlashAttention" in type(o.grad_fn).__name__
    assert _rel(o.detach().transpose(1, 2).numpy(), ref_o) < REL_TOL
    o.backward(torch.from_numpy(do).transpose(1, 2))
    for name, t, r in zip("qkv", leaves, ref):
        assert _rel(t.grad.transpose(1, 2).numpy(), r) < GRAD_REL, name


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8), (True, 8)])
def test_flash_attention_still_refuses_a_banded_sq_other_than_sk(causal, window):
    """A causal or windowed mask at Sq != Sk is refused, under grad and in
    serving: the reference aligns those masks at the end, the kernels'
    index masks at the start."""
    q = torch.zeros(1, 2, 8, 16, requires_grad=True)
    k = torch.zeros(1, 2, 12, 16, requires_grad=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_grad(q, k, k, causal=causal, window=window)
    with torch.inference_mode(), pytest.raises(ValueError, match="Sq == Sk"):
        flash_grad(q.detach(), k.detach(), k.detach(), causal=causal, window=window)
