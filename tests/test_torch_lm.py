"""The port's LM stack (reduced gemma3-1b, mamba2-1.3b, zamba2-7b and
moonshot-v1-16b-a3b) against JAX.

The reference's `init_lm` weights, loaded into the port with `from_jax`,
go through both stacks on the CPU with the same seeded tokens: full
logits, prefill logits and caches, teacher-forced decode logits, and
`Engine.run`'s tokens.  For zamba2 the leaves that the reference draws
as constants (`lora_*_b` zeros, so a fresh LoRA adds nothing; the three
`lora_*_a` equal; mamba's `A_log`, `dt_bias`, `D`) get seeded
non-trivial values first, in the numpy tree fed to both
(`_torch_params.nontrivial`).  The reference runs under
``overrides(flash_p_dtype="float32")``: its default rounds the softmax
probabilities P to bf16 before the PV product, which the Pallas kernel
and the port do not.

Tolerances: rel 1e-4 (max abs error over max |ref|) for logits -- both
sides f32, summed in different orders through up to 8 layers (observed
~1e-6); 1e-6 absolute for caches at one layer of depth or less; 2e-2 for
the reference's bf16-P default, whose per-element P rounding (2^-9
relative) accumulates through the stack (observed ~4e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs
from repro.models import init_lm as jax_init_lm
from repro.models import lm_decode_step as jax_decode_step
from repro.models import lm_logits as jax_lm_logits
from repro.models import lm_prefill as jax_prefill
from repro.models import mamba as jax_mamba
from repro.models.blocks import build_stack_plan as jax_stack_plan
from repro.models.runtime_flags import overrides
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_arch
from repro_torch.models import from_jax, init_lm, lm_decode_step, lm_logits, lm_prefill
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.blocks import build_stack_plan
from repro_torch.models.common import Params
from repro_torch.serve import Engine, Request, ServeConfig

from _torch_params import nontrivial  # the seeded constant-drawn leaves

ARCHS = ("gemma3-1b", "mamba2-1.3b", "zamba2-7b", "moonshot-v1-16b-a3b")
REL_TOL = 1e-4
CACHE_ATOL = 1e-6
BF16_P_TOL = 2e-2


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(name, jax cfg, jax params, port model) for a reduced arch."""
    name = request.param
    cfg = jax_get_arch(name).reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    if name == "zamba2-7b":
        params = jax.tree.map(jnp.asarray, nontrivial(jax.tree.map(np.asarray, params)))
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(name).reduced(),
                     device="cpu")
    return name, cfg, params, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_lm_logits_match_jax(pair):
    name, cfg, params, model = pair
    toks = _tokens(cfg, (2, 28))
    with overrides(flash_p_dtype="float32"):
        ref = np.asarray(jax_lm_logits(params, cfg, jnp.asarray(toks)))
    y = lm_logits(model, torch.from_numpy(toks).long()).numpy()
    assert y.shape == ref.shape == (2, 28, cfg.vocab_size)
    assert _rel(y, ref) < REL_TOL, name


def _flat_jax_caches(cfg, state):
    """The reference's per-group stacked caches, in the port's flat layer
    order (group, repeat, position)."""
    out = []
    for gspec, gcache in zip(jax_stack_plan(cfg), state["groups"]):
        for r in range(gspec.n_repeat):
            for i in range(len(gspec.layers)):
                out.append({k: np.asarray(v[r]) for k, v in gcache[i]["self"].items()})
    return out


def test_prefill_logits_and_caches_match_jax(pair):
    name, cfg, params, model = pair
    toks = _tokens(cfg, (2, 24), seed=1)
    with overrides(flash_p_dtype="float32"):
        ref_logits, ref_state = jax_prefill(params, cfg, jnp.asarray(toks), 40)
    logits, state = lm_prefill(model, torch.from_numpy(toks).long(), 40)
    assert _rel(logits.numpy(), ref_logits) < REL_TOL, name
    ref_caches = _flat_jax_caches(cfg, ref_state)
    # one cache per layer of the plan: zamba2's shared invocations have theirs
    n_shared = sum(spec.mixer == "shared_attn" for spec in model.specs)
    assert len(state["layers"]) == len(ref_caches) == cfg.n_layers + n_shared
    for i, (c, rc) in enumerate(zip(state["layers"], ref_caches)):
        assert set(c) == set(rc), (name, i)
        for key in c:
            assert tuple(c[key].shape) == rc[key].shape, (name, i, key)
            if key == "pos":
                np.testing.assert_array_equal(c[key].numpy(), rc[key])
            elif i == 0:  # the first layer's cache sees no accumulated error
                np.testing.assert_allclose(c[key].numpy(), rc[key], atol=CACHE_ATOL)
            else:
                assert _rel(c[key].numpy(), rc[key]) < REL_TOL, (name, i, key)


def test_teacher_forced_decode_matches_jax(pair):
    name, cfg, params, model = pair
    toks = _tokens(cfg, (2, 30), seed=2)
    # the full forward of 60 tokens at MoE capacity 56 may drop pairs that
    # the prefill (48 tokens, capacity 48) and the decode steps (capacity
    # 8 for 2) cannot: it is held at a capacity factor that drops nothing
    full_cfg = cfg if not cfg.moe else dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    with overrides(flash_p_dtype="float32"):
        _, ref_state = jax_prefill(params, cfg, jnp.asarray(toks[:, :24]), 40)
        ref_full = np.asarray(jax_lm_logits(params, full_cfg, jnp.asarray(toks)))
    _, state = lm_prefill(model, torch.from_numpy(toks[:, :24]).long(), 40)
    for t in range(24, 30):
        with overrides(flash_p_dtype="float32"):
            ref, ref_state = jax_decode_step(
                params, cfg, jnp.asarray(toks[:, t]), jnp.int32(t), ref_state
            )
        y, state = lm_decode_step(model, torch.from_numpy(toks[:, t]).long(), t, state)
        assert _rel(y.numpy(), ref) < REL_TOL, (name, t)
        # and incremental decode agrees with the full forward, as the
        # reference's own decode test demands
        assert _rel(y.numpy(), ref_full[:, t]) < 2e-3, (name, t)


def test_reference_default_bf16_p_within_looser_tolerance():
    """At the reference's default P dtype (bf16) gemma3's logits differ
    from the port's f32 P by the bf16 rounding only."""
    cfg = jax_get_arch("gemma3-1b").reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), get_arch("gemma3-1b").reduced(),
                     device="cpu")
    toks = _tokens(cfg, (2, 28))
    with overrides(flash_p_dtype="bfloat16"):
        ref = np.asarray(jax_lm_logits(params, cfg, jnp.asarray(toks)))
    err = _rel(lm_logits(model, torch.from_numpy(toks).long()).numpy(), ref)
    assert REL_TOL < err < BF16_P_TOL  # the rounding shows, and stays small


def test_sliding_window_ring_buffer_wraps():
    """gemma3's reduced config has window 16 < prefix 24: the local caches
    are window-sized rings holding the last 16 positions at slot p % 16,
    the global cache is dense max_len (counterpart of the reference's
    `test_sliding_window_ring_buffer_wraps`)."""
    cfg = get_arch("gemma3-1b").reduced()
    assert cfg.sliding_window == 16
    model = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 24))).long()
    _, state = lm_prefill(model, toks, 64)
    local, glob = state["layers"][0], state["layers"][5]
    assert model.specs[0].window == 16 and model.specs[5].window == 0
    assert tuple(local["k"].shape) == (1, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert tuple(glob["k"].shape) == (1, 64, cfg.n_kv_heads, cfg.resolved_head_dim)
    pos = local["pos"][0].tolist()
    assert sorted(pos) == list(range(8, 24))
    assert all(p % 16 == slot for slot, p in enumerate(pos))
    assert glob["pos"][0].tolist() == list(range(24)) + [-1] * 40


def test_mamba_state_is_constant_size():
    cfg = get_arch("mamba2-1.3b").reduced()
    model = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 32))).long()
    _, small = lm_prefill(model, toks, 64)
    _, large = lm_prefill(model, toks, 4096)
    size = lambda st: sum(t.numel() for c in st["layers"] for t in c.values())
    assert size(small) == size(large)  # O(1) in context length


def test_mamba_prefill_is_the_recurrence_where_the_reference_overflows():
    """At a long chunk and a large dt, the reference's intra-chunk decay
    exp(la[t] - la[s]) overflows above the diagonal before the causal mask
    multiplies it away (inf * 0 = NaN); the full mamba2-1.3b config does
    this at its 256-step chunk.  The port masks before the exp, and its
    chunked prefill equals the step-by-step recurrence (`mamba_decode`
    from an empty state) -- an independent computation of the same
    function.  Tolerance rel 1e-4: f32, two summation orders."""
    def cfg_of(get):
        cfg = get("mamba2-1.3b").reduced()
        return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=64))

    jcfg, cfg = cfg_of(jax_get_arch), cfg_of(get_arch)
    jp = jax.tree.map(np.asarray, jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32))
    jp["dt_bias"] = np.full_like(jp["dt_bias"], 4.0)  # dt ~ 4: la reaches ~ -256
    x = np.random.default_rng(6).standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    with overrides(flash_p_dtype="float32"):
        ref = np.asarray(jax_mamba.mamba_forward(jp, jnp.asarray(x), jcfg))
    assert np.isnan(ref).any()  # the reference fault this guards against

    p = Params({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    xt = torch.from_numpy(x)
    y = mamba_mod.mamba_forward(p, xt, cfg)
    cache = mamba_mod.init_mamba_cache(cfg, 1, torch.float32, "cpu")
    steps = []
    for t in range(x.shape[1]):
        out, cache = mamba_mod.mamba_decode(p, xt[:, t : t + 1], cache, cfg)
        steps.append(out)
    rec = torch.cat(steps, dim=1)
    assert torch.isfinite(y).all()
    assert _rel(y.numpy(), rec.numpy()) < REL_TOL


def test_engine_serves_the_same_tokens_as_jax(pair):
    """Greedy `Engine.run` over two waves (one partial), prompts right-
    aligned, one longer than gemma3's reduced window: the same tokens."""
    name, cfg, params, model = pair
    lengths, new = (5, 20, 12), 6
    prompts = [_tokens(cfg, (n,), seed=10 + i) for i, n in enumerate(lengths)]
    with overrides(flash_p_dtype="float32"):
        ref = JaxEngine(params, cfg, JaxServeConfig(max_batch=2, max_len=64)).run(
            [JaxRequest(i, p, max_new_tokens=new) for i, p in enumerate(prompts)]
        )
    eng = Engine(model, ServeConfig(max_batch=2, max_len=64))
    out = eng.run([Request(i, p, max_new_tokens=new) for i, p in enumerate(prompts)])
    assert out == ref, name
    assert [w["size"] for w in eng.waves] == [2, 1]
    assert all(w["decode_steps"] == new for w in eng.waves)


def test_engine_stops_at_eos():
    cfg = get_arch("mamba2-1.3b").reduced()
    model = init_lm(cfg, seed=0, device="cpu")
    prompt = _tokens(cfg, (7,))
    free = Engine(model, ServeConfig(max_batch=1, max_len=32)).run(
        [Request(0, prompt, max_new_tokens=5)])[0]
    stop = Engine(model, ServeConfig(max_batch=1, max_len=32, eos_id=free[1])).run(
        [Request(0, prompt, max_new_tokens=5)])[0]
    assert stop == free[: free.index(free[1]) + 1]


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    cfg = get_arch("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg, seed=0)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jax_get_arch("gemma3-1b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(jax.tree.map(np.asarray, jparams), cfg)
    from repro_torch.launch import serve as launcher

    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--requests", "1"])
    assert init_lm(cfg, seed=0, device="cpu").device.type == "cpu"


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as launcher

    launcher.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--requests", "3",
                   "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


def test_launcher_serves_zamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve as launcher

    launcher.main(["--arch", "zamba2-7b", "--device", "cpu", "--requests", "3",
                   "--max-new", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


def test_zamba2_plan_and_shared_block_are_the_reference():
    """zamba2-7b's full plan: 13 super-blocks of [shared attention, 6 x
    mamba] and a tail of 3 mamba layers, as the reference builds it; the
    reduced model carries one shared block, and each invocation its own
    norms and LoRA of the configured rank (no MLP of its own)."""
    full = get_arch("zamba2-7b")
    plan = [(g.n_repeat, tuple(s.mixer for s in g.layers))
            for g in build_stack_plan(full)]
    ref = [(g.n_repeat, tuple(s.mixer for s in g.layers)) for g in jax_stack_plan(
        jax_get_arch("zamba2-7b"))]
    assert plan == ref == [(13, ("shared_attn",) + ("mamba",) * 6), (1, ("mamba",) * 3)]
    cfg = get_arch("zamba2-7b").reduced()
    model = init_lm(cfg, seed=0, device="cpu")
    assert sorted(n for n, _ in model.shared_block.named_parameters()) == [
        "attn.wk", "attn.wo", "attn.wq", "attn.wv", "mlp.w1", "mlp.w2", "mlp.w3"]
    lp = model.layers[0]
    rank = max(1, cfg.shared_attn_lora_rank)
    assert sorted(n for n, _ in lp.named_parameters()) == sorted(
        ["ln1", "ln2"] + [f"lora_{t}_{ab}" for t in "qkv" for ab in "ab"])
    assert tuple(lp["lora_q_a"].shape) == (cfg.d_model, rank)
    assert not lp["lora_k_b"].any()  # a fresh LoRA adds nothing, as in the reference


# MLA / MoE / MTP, encoder-decoder
UNPORTED = ("deepseek-v3-671b", "seamless-m4t-medium")
OTHER_DENSE = sorted(set(list_archs()) - set(ARCHS) - set(UNPORTED))


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_archs_raise_not_implemented(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_lm(get_arch(name).reduced(), seed=0, device="cpu")


@pytest.mark.parametrize("name", OTHER_DENSE)
def test_other_dense_archs_match_jax(name):
    """The remaining dense GQA configs (qk-norm, QKV bias, MHA) run through
    the same attention + MLP layers and match the reference too."""
    cfg = jax_get_arch(name).reduced()
    params = jax_init_lm(jax.random.PRNGKey(0), cfg)
    model = from_jax(jax.tree.map(np.asarray, params), get_arch(name).reduced(),
                     device="cpu")
    toks = _tokens(cfg, (2, 20))
    with overrides(flash_p_dtype="float32"):
        ref = np.asarray(jax_lm_logits(params, cfg, jnp.asarray(toks)))
    assert _rel(lm_logits(model, torch.from_numpy(toks).long()).numpy(), ref) < REL_TOL
