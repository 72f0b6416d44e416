"""DeepSeek-V3's MLA and MTP head in the port against JAX.

The reference's `init_lm` weights of reduced deepseek-v3-671b (4 MLA +
MoE layers, q_lora 32, kv_lora 16, nope 8, rope 8, v 8: q/k head dim 16,
v head dim 8; 8 experts, one shared; the MTP head), loaded with
`from_jax`, go through both stacks on the CPU with the same seeded
inputs: one MLA layer's output and latents, the absorbed decode
teacher-forced step by step against the reference's expanded baseline,
`lm_loss` with `mtp_nll`, and the MTP head's and MLA's gradients by
name.  The plain flash functions are held against `jax.vjp` of the
reference's `flash_attention` at q/k and v head dims apart.  The
reference runs under ``overrides(flash_p_dtype="float32")``, as the port
keeps P in f32.  deepseek-v3 is also a case of the parametrised tests of
`tests/test_torch_lm.py` (logits, the prefill's latent cache, the
absorbed decode against the reference's default, `Engine` tokens) and
`tests/test_torch_train.py` (every gradient leaf, remat on and off).

Tolerances: rel 1e-4 (max abs error over max |ref|) for outputs and
gradients -- both sides f32, summed in other orders through up to 4
layers (observed ~1e-6); the loss and its terms rel 1e-5; the plain
flash functions abs 5e-5 (gradients) and 1e-5 (output, lse), the
tolerances of `tests/test_flash_attention.py`.
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
from repro.models import lm_prefill as jax_prefill
from repro.models.flash_attention import flash_attention as jax_flash
from repro.models.lm import lm_loss as jax_lm_loss
from repro.models.runtime_flags import overrides
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd_ref, lse_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn_mod
from repro_torch.models import from_jax, init_lm, lm_decode_step, lm_loss, lm_prefill
from repro_torch.models.common import Params

NAME = "deepseek-v3-671b"
REL_TOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
GRAD_ATOL = 5e-5
LSE_ATOL = 1e-5


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model) of reduced deepseek-v3-671b."""
    cfg = jax_get_arch(NAME).reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(NAME).reduced(), device="cpu")
    return cfg, params, model


def test_reduced_config_is_the_reference(pair):
    """The port's deepseek-v3-671b and its `.reduced()` equal the
    reference's field by field; the reduced MLA is q/k hd 16, v hd 8."""
    for cfg, ref in ((get_arch(NAME), jax_get_arch(NAME)),
                     (get_arch(NAME).reduced(), jax_get_arch(NAME).reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    m = get_arch(NAME).reduced().mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim) == (
        32, 16, 8, 8, 8)
    full = get_arch(NAME)
    assert full.mla.qk_nope_dim + full.mla.qk_rope_dim == 192 and full.mla.v_head_dim == 128
    assert full.resolved_head_dim == 56  # the MTP block's attention


def test_plan_is_mla_with_experts_and_the_model_carries_mtp(pair):
    _, _, model = pair
    assert [(s.mixer, s.moe) for s in model.specs] == [("mla", True)] * 4
    names = dict(model.named_parameters())
    assert sorted(n[len("mtp."):] for n in names if n.startswith("mtp.")) == sorted(
        ["proj", "norm_h", "norm_e", "block.ln1", "block.ln2"]
        + [f"block.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
        + [f"block.mlp.{w}" for w in ("w1", "w2", "w3")])
    assert sorted(n[len("layers.0.attn."):] for n in names if n.startswith("layers.0.attn.")) == [
        "kv_a_norm", "q_a_norm", "wk_b", "wkv_a", "wo", "wq_a", "wq_b", "wv_b"]


def test_from_jax_carries_the_mtp_head(pair):
    cfg, params, model = pair
    want = jax.tree_util.tree_flatten_with_path(params["mtp"])[0]
    got = dict(model["mtp"].named_parameters())
    assert len(want) == len(got)
    for path, leaf in want:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf))


def test_init_lm_builds_the_mtp_head_at_the_reference_shapes():
    cfg = get_arch(NAME).reduced()
    model = init_lm(cfg, seed=0, device="cpu")
    ref = jax_init_lm(jax.random.PRNGKey(0), jax_get_arch(NAME).reduced())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref_model = from_jax(jax.tree.map(np.asarray, ref), cfg, device="cpu")
    assert shapes == {n: tuple(p.shape) for n, p in ref_model.named_parameters()}
    assert tuple(model["mtp"].proj.shape) == (2 * cfg.d_model, cfg.d_model)


def test_mla_forward_and_latents_match_jax(pair):
    cfg, params, model = pair
    jp = jax.tree.map(lambda a: np.asarray(a[0]), params["stack"][0]["layers"][0]["attn"])
    p = Params({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    with overrides(flash_p_dtype="float32"):
        ry, (rc, rk) = jax_attn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), cfg,
                                             return_latent=True)
    y, (c_kv, k_rope) = attn_mod.mla_forward(p, torch.from_numpy(x),
                                             torch.from_numpy(pos.copy()), model.cfg,
                                             return_latent=True)
    assert y.shape == ry.shape and c_kv.shape == rc.shape and k_rope.shape == rk.shape
    assert _rel(y.numpy(), ry) < REL_TOL
    assert _rel(c_kv.numpy(), rc) < REL_TOL
    assert _rel(k_rope.numpy(), rk) < REL_TOL


def test_absorbed_decode_matches_the_reference_expanded_decode(pair):
    """The port's one decode (absorbed) against the reference's expanded
    baseline (`mla_absorb=False`, which re-expands k and v over the whole
    cache every step), teacher-forced over 6 tokens: the same function.
    (Against the reference's default absorbed decode, and with the
    prefill's latent cache, logits and `Engine` tokens, deepseek-v3 is a
    case of `tests/test_torch_lm.py`'s parametrised tests.)"""
    cfg, params, model = pair
    toks = _tokens(cfg, (2, 30), seed=2)
    with overrides(flash_p_dtype="float32", mla_absorb=False):
        _, ref_state = jax_prefill(params, cfg, jnp.asarray(toks[:, :24]), 40)
    _, state = lm_prefill(model, torch.from_numpy(toks[:, :24]).long(), 40)
    for t in range(24, 30):
        with overrides(flash_p_dtype="float32", mla_absorb=False):
            ref, ref_state = jax_decode_step(params, cfg, jnp.asarray(toks[:, t]), jnp.int32(t),
                                             ref_state)
        y, state = lm_decode_step(model, torch.from_numpy(toks[:, t]).long(), t, state)
        assert _rel(y.numpy(), ref) < REL_TOL, t
        assert int(state["layers"][0]["pos"][0, t]) == t


def _batch(vocab, b=2, s=24, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    if masked:
        mask[0, -5:] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k != "mask" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference_grads(pair):
    cfg, params, _ = pair
    batch = _batch(cfg.vocab_size)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    g_model = from_jax(jax.tree.map(np.asarray, grads), get_arch(NAME).reduced(), device="cpu")
    return batch, float(loss), {k: float(v) for k, v in metrics.items()}, g_model


@pytest.mark.parametrize("masked", [True, False])
def test_lm_loss_with_mtp_nll_matches_jax(pair, masked):
    """loss = nll + moe_aux + moe_z + 0.3 mtp_nll, each term rel 1e-5 of
    the reference's, with and without a mask (the MTP head's mask is the
    batch's shifted by one)."""
    cfg, params, model = pair
    batch = _batch(cfg.vocab_size, seed=4, masked=masked)
    with overrides(flash_p_dtype="float32"):
        ref_loss, ref_metrics = jax_lm_loss(
            params, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = lm_loss(model, _torch_batch(batch))
    assert set(metrics) == set(ref_metrics) == {"nll", "moe_aux", "moe_z", "mtp_nll", "loss"}
    for k, v in metrics.items():
        assert _rel(float(v), float(ref_metrics[k])) < LOSS_REL, k
    assert float(metrics["mtp_nll"]) > 0
    assert abs(float(loss) - float(metrics["nll"] + metrics["moe_aux"] + metrics["moe_z"]
                                   + 0.3 * metrics["mtp_nll"])) < 1e-5


def test_mtp_and_mla_gradients_by_name(pair, reference_grads):
    """The MTP head's leaves and layer 0's MLA weights take non-zero
    gradients that match the reference's leaf of the same name (rel 1e-4;
    `tests/test_torch_train.py` holds every leaf of deepseek-v3, with and
    without remat)."""
    cfg, params, _ = pair
    batch, ref_loss, _, g_model = reference_grads
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(NAME).reduced(), device="cpu")
    model.requires_grad_(True)
    loss, _ = lm_loss(model, _torch_batch(batch))
    assert _rel(float(loss.detach()), ref_loss) < LOSS_REL
    named = dict(model.named_parameters())
    picked = [n for n in named if n.startswith(("mtp.", "layers.0.attn."))]
    assert len(picked) == 20  # the MTP head's 12 leaves and layer 0's 8 MLA leaves
    grads = torch.autograd.grad(loss, [named[n] for n in picked])
    want = dict(g_model.named_parameters())
    for n, g in zip(picked, grads):
        ref = want[n].detach().numpy()
        assert np.abs(ref).max() > 0 and g.abs().max() > 0, n
        assert _rel(g.numpy(), ref) < GRAD_REL, n


PLAIN_CASES = [  # (b, s, hq, hkv, hd, vd, window, q_blk, kv_blk)
    (2, 48, 4, 4, 16, 8, 0, 16, 16),  # the reduced MLA
    (1, 40, 4, 2, 24, 16, 12, 8, 8),  # GQA, a window, a ragged tail
]


@pytest.mark.parametrize("case", PLAIN_CASES, ids=lambda c: "hd{}vd{}w{}".format(*c[4:7]))
def test_plain_flash_functions_at_split_head_dims_match_the_reference_vjp(case):
    """`attention_ref` (out vd wide, scale q's hd^-0.5), `lse_ref` and
    `flash_attention_bwd_ref` (dv vd wide) at hd_qk != hd_v, against the
    reference's `flash_attention` and `jax.vjp` of it."""
    b, s, hq, hkv, hd, vd, window, qb, kb = case
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, vd)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, vd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, pos, pos, window=window, causal=True,
                         q_blk=qb, kv_blk=kb, p_dtype=jnp.float32)

    ref_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    bhsd = lambda x: torch.from_numpy(x).transpose(1, 2)
    qt, kt, vt = bhsd(q), bhsd(k), bhsd(v)
    o = attention_ref(qt, kt, vt, causal=True, window=window)
    assert tuple(o.shape) == (b, hq, s, vd)
    assert float(np.abs(o.transpose(1, 2).numpy() - np.asarray(ref_o)).max()) < LSE_ATOL
    lse = lse_ref(qt, kt, causal=True, window=window)
    s_ref = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, hq // hkv, axis=2)) * hd ** -0.5
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    ok = (j <= i) & ((i - j < window) if window else True)
    s_ref = np.where(ok, s_ref, -np.inf)
    lse_np = np.log(np.exp(s_ref - s_ref.max(-1, keepdims=True)).sum(-1)) + s_ref.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_np, rtol=0, atol=LSE_ATOL)
    grads = flash_attention_bwd_ref(qt, kt, vt, o, lse, bhsd(do), causal=True, window=window)
    for name, g, r in zip("qkv", grads, ref):
        g = g.transpose(1, 2).numpy()
        assert g.shape == r.shape, name
        assert float(np.abs(g - r).max()) < GRAD_ATOL, name


def test_launcher_serves_deepseek_reduced_on_the_cpu(capsys):
    launch_serve.main(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


def test_launcher_trains_deepseek_reduced_on_the_cpu(tmp_path, capsys):
    """deepseek-v3-671b `--reduced` (4 MLA + MoE layers and the MTP head)
    trains through the launcher; each step's record holds nll, mtp_nll
    and the aux losses, finite and non-zero, and the checkpoint the MTP
    head's leaves."""
    state, history = launch_train.main([
        "--arch", NAME, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--seq", "40", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [h["step"] for h in history] == [0, 1]
    for h in history:
        for k in ("loss", "grad_norm", "nll", "mtp_nll", "moe_aux", "moe_z"):
            assert np.isfinite(h[k]) and h[k] != 0, k
        assert h["loss"] > h["nll"]  # the MTP and aux terms add
    assert f"[train] arch={NAME}" in capsys.readouterr().out
    assert "mtp.block.attn.wq" in dict(state["params"].named_parameters())
