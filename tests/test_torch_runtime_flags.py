"""The port's runtime flags (`repro_torch.models.runtime_flags`) and every
place that reads them, against the reference under the same flags.

`chunked_attention` in both branches; every arch of the registry at
`.reduced()` under `set_baseline()` (prefill logits and four decode
steps); `lm_loss` and every gradient under the baseline; MLA's expanded
decode; mamba's chunk override and per-chunk remat; the baseline's
sharding builders on the 16 x 16 logical mesh; the context-parallel
prefill rule.  Inputs and weights are seeded numpy arrays handed to
both packages (the reference's `init_lm` tree through `from_jax`, its
constant-drawn leaves seeded by `_torch_params.nontrivial`).

`FLAGS` is one object per process in each package and the suite runs
files side by side in worker processes, so every test that sets a flag
does it inside `both_flags`, which restores both packages' flags after.
The reference's test conftest sets its `flash_p_dtype` to "float32";
`set_baseline()` sets the same.

Tolerances (max abs error over max |ref|): `chunked_attention` rel 1e-5
in fp32 and 1e-2 in bf16; a model's logits rel 1e-4 (`tests/
test_torch_lm.py`'s); the loss rel 1e-5 and every gradient leaf rel 1e-4
(`tests/test_torch_train.py`'s); MLA's decodes rel 1e-4; per-chunk remat
bitwise.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs
from repro.models import attention as jax_attn
from repro.models import init_lm as jax_init_lm
from repro.models import lm_decode_step as jax_decode_step
from repro.models import lm_prefill as jax_prefill
from repro.models import mamba as jax_mamba
from repro.models import runtime_flags as jax_flags
from repro.models.lm import lm_loss as jax_lm_loss
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.models import attention as attn_mod
from repro_torch.models import from_jax, lm_decode_step, lm_loss, lm_prefill
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import runtime_flags as port_flags

from _torch_params import nontrivial  # the seeded constant-drawn leaves

_ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = tuple(list_archs())
SRC_FRAMES = 16
REL_TOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


@contextlib.contextmanager
def both_flags(impl=None, **kw):
    """Both packages' flags set by `impl` ("baseline" / "optimized") and
    then `kw`, every field restored on exit."""
    jold = dataclasses.asdict(jax_flags.FLAGS)
    try:
        with port_flags.restored():
            for mod in (jax_flags, port_flags):
                if impl:
                    getattr(mod, f"set_{impl}")()
                for k, v in kw.items():
                    setattr(mod.FLAGS, k, v)
            yield
    finally:
        for k, v in jold.items():
            setattr(jax_flags.FLAGS, k, v)


# ------------------------------------------------------------------ the flags


# The reference's fields the port leaves out (its module docstring says why).
ABSENT = ("flash_p_dtype", "flash_q_blk", "flash_kv_blk", "moe_shardmap")


def _ref_fields(flags) -> dict:
    return {k: v for k, v in dataclasses.asdict(flags).items() if k not in ABSENT}


def test_flags_are_the_reference_s():
    """Every field and default but the four left out, and what
    `set_baseline` / `set_optimized` set, are the reference's; the four
    left out raise like any unknown name; `overrides` restores and refuses
    an unknown name; `restored` undoes a `set_*`."""
    assert dataclasses.asdict(port_flags.Flags()) == _ref_fields(jax_flags.Flags())
    for impl in ("baseline", "optimized"):
        with both_flags(impl):
            assert dataclasses.asdict(port_flags.FLAGS) == _ref_fields(jax_flags.FLAGS)
    before = dataclasses.asdict(port_flags.FLAGS)
    assert before == dataclasses.asdict(port_flags.Flags())
    with port_flags.overrides(mla_absorb=False, ssm_chunk_override=32):
        assert not port_flags.FLAGS.mla_absorb and port_flags.FLAGS.ssm_chunk_override == 32
    assert dataclasses.asdict(port_flags.FLAGS) == before
    for name in ("no_such_flag", *ABSENT):
        with pytest.raises(AttributeError):
            with port_flags.overrides(**{name: 1}):
                pass
        with pytest.raises(AttributeError):
            setattr(port_flags.FLAGS, name, 1)
    with port_flags.restored():
        port_flags.set_baseline()
        assert port_flags.FLAGS.attention_impl == "chunked"
    assert dataclasses.asdict(port_flags.FLAGS) == before


# ------------------------------------------------------------ chunked attention

ATTN_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, hd, vd, window, causal, masked slots)
    "sk700-gqa-causal": (2, 12, 700, 4, 2, 32, 32, 0, True, 0),
    "sk1100-gqa-window": (2, 12, 1100, 4, 1, 32, 32, 300, True, 40),
    "sk1100-mla-192-128": (1, 6, 1100, 2, 2, 192, 128, 0, True, 0),
    "sk700-noncausal": (2, 9, 700, 2, 2, 16, 16, 0, False, 25),
    "sk40-one-chunk": (2, 7, 40, 4, 2, 16, 16, 0, True, 5),
    "sq1-decode-sk1100": (3, 1, 1100, 4, 2, 32, 32, 0, True, 300),
}


def _attn_inputs(case, dtype):
    b, sq, sk, hq, hkv, hd, vd, window, causal, holes = ATTN_CASES[case]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, vd)).astype(np.float32)
    if dtype == "bfloat16":  # the same values on both sides
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    kv_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    if holes:  # empty cache slots at the end of every row
        kv_pos[:, -holes:] = -1
    q_pos = rng.integers(0, sk, (b, sq)).astype(np.int32)
    q_pos[0, 0] = -1 if causal else q_pos[0, 0]  # a fully masked row
    return (q, k, v, q_pos, kv_pos), dict(window=window, causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "chunked"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_the_reference(case, impl, dtype):
    """Both branches (the one-shot pass under "flash" at Sq 1 or one
    chunk; the 512-key loop otherwise), padded key counts, GQA, a window,
    (192, 128), empty slots, a fully masked row, causal or not."""
    (q, k, v, q_pos, kv_pos), kw = _attn_inputs(case, dtype)
    with both_flags(attention_impl=impl):
        ref = jax_attn.chunked_attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                                         jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw)
        tdt = getattr(torch, dtype)
        y = attn_mod.chunked_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                       torch.from_numpy(q_pos), torch.from_numpy(kv_pos), **kw)
    assert y.dtype == getattr(torch, dtype) and tuple(y.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    y = y.float().numpy()
    if kw["causal"]:  # the fully masked row is exactly zero on both sides
        assert not y[0, 0].any() and not ref[0, 0].any()
    assert np.isfinite(y).all()
    assert _rel(y, ref) < (1e-5 if dtype == "float32" else 1e-2), case


def test_chunked_attention_takes_the_chunk_loop_under_grad():
    """Autograd differentiates the loop: the gradients of q, k and v
    against `jax.grad` of the reference's scan."""
    (q, k, v, q_pos, kv_pos), kw = _attn_inputs("sk1100-gqa-window", "float32")
    w = np.random.default_rng(5).standard_normal((2, 12, 4, 32)).astype(np.float32)
    with both_flags(attention_impl="chunked"):
        ref = jax.grad(lambda q, k, v: jnp.sum(jax_attn.chunked_attention(
            q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = attn_mod.chunked_attention(*t, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                                         **kw)
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), t)
    for g, r in zip(grads, ref):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g.numpy(), r) < 1e-5


def test_full_attention_dispatches_by_the_flags(monkeypatch):
    """"flash" reaches the flash entry point; "chunked" and a context-
    parallel axis reach `chunked_attention` with positions 0..S-1."""
    calls = []
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0].new_zeros(a[0].shape))
    real = attn_mod.chunked_attention

    def chunked(q, k, v, q_pos, kv_pos, **kw):
        assert torch.equal(q_pos[0], torch.arange(q.shape[1], dtype=torch.int32))
        calls.append("chunked")
        return real(q, k, v, q_pos, kv_pos, **kw)

    monkeypatch.setattr(attn_mod, "chunked_attention", chunked)
    q = torch.randn(1, 9, 2, 8, generator=torch.Generator().manual_seed(0))
    attn_mod.full_attention(q, q, q)
    with both_flags(attention_impl="chunked"):
        attn_mod.full_attention(q, q, q)
    with both_flags(attention_cp_axis="model"):
        attn_mod.full_attention(q, q, q)
    assert calls == ["flash", "chunked", "chunked"]


# ------------------------------------------------------ every arch, baseline


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(name, jax cfg, jax params, port model) for a reduced arch."""
    name = request.param
    cfg = jax_get_arch(name).reduced()
    tree = nontrivial(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg)))
    return name, cfg, jax.tree.map(jnp.asarray, tree), from_jax(
        tree, get_arch(name).reduced(), device="cpu")


def test_baseline_prefill_and_decode_match_the_reference(pair):
    """Prefill logits and four decode steps of every arch under
    `set_baseline()` in both packages: the chunked loop, the chunked
    decode, MLA's expanded decode, no SSD chunk remat."""
    name, cfg, params, model = pair
    toks = _tokens(cfg, (2, 24), seed=3)
    kw, tkw = {}, {}
    if cfg.is_encoder_decoder:
        src = np.random.default_rng(4).standard_normal((2, SRC_FRAMES, cfg.d_model))
        kw = {"src_embeds": jnp.asarray(src.astype(np.float32))}
        tkw = {"src_embeds": torch.from_numpy(src.astype(np.float32))}
    with both_flags("baseline"):  # the reference traces under these flags
        prefill = jax.jit(lambda p, t, kw: jax_prefill(p, cfg, t, 40, **kw))
        step = jax.jit(lambda p, t, pos, st: jax_decode_step(p, cfg, t, pos, st))
        ref, ref_state = prefill(params, jnp.asarray(toks[:, :20]), kw)
        y, state = lm_prefill(model, torch.from_numpy(toks[:, :20]).long(), 40, **tkw)
        assert _rel(y.numpy(), ref) < REL_TOL, (name, "prefill")
        for t in range(20, 24):
            ref, ref_state = step(params, jnp.asarray(toks[:, t]), jnp.int32(t), ref_state)
            y, state = lm_decode_step(model, torch.from_numpy(toks[:, t]).long(), t, state)
            assert np.isfinite(y.numpy()).all()
            assert _rel(y.numpy(), ref) < REL_TOL, (name, t)


GRAD_ARCHS = ("gemma3-1b", "mamba2-1.3b", "deepseek-v3-671b")


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_baseline_loss_and_every_gradient_match_the_reference(name):
    """`lm_loss` and every gradient under `set_baseline()`: autograd
    through the chunked loop (MLA's too) against `jax.grad` of the
    reference's scan; mamba2 without per-chunk remat."""
    cfg = jax_get_arch(name).reduced()
    tree = nontrivial(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32)
    mask = np.ones((2, 24), np.float32)
    mask[0, -5:] = 0.0
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    model = from_jax(tree, get_arch(name).reduced(), device="cpu")
    model.requires_grad_(True)
    with both_flags("baseline"):
        (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm_loss(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True))(jax.tree.map(jnp.asarray, tree))
        loss, _ = lm_loss(model, {k: torch.from_numpy(v).long() if k != "mask"
                                  else torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(float(loss.detach()), float(ref_loss)) < LOSS_REL
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want = dict(from_jax(jax.tree.map(np.asarray, ref_grads), get_arch(name).reduced(),
                         device="cpu").named_parameters())
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert _rel(g.numpy(), want[n].detach().numpy()) < GRAD_REL, (name, n)


# ------------------------------------------------------------ MLA decode


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_mla_expanded_decode_matches_the_reference(impl):
    """`mla_absorb=False`: the whole cache's latents expanded and attended
    by `chunked_attention` (its one-shot pass under "flash", its loop
    under "chunked"), against the reference's expanded decode and the
    port's absorbed one."""
    cfg = jax_get_arch("deepseek-v3-671b").reduced()
    p = jax.tree.map(np.array, jax_attn.init_mla(jax.random.PRNGKey(1), cfg, jnp.float32))
    rng = np.random.default_rng(7)
    b, max_len, n = 2, 40, 23
    m = cfg.mla
    c_kv = np.zeros((b, max_len, m.kv_lora_rank), np.float32)
    k_rope = np.zeros((b, max_len, m.qk_rope_dim), np.float32)
    pos = np.full((b, max_len), -1, np.int32)
    c_kv[:, :n] = rng.standard_normal((b, n, m.kv_lora_rank))
    k_rope[:, :n] = rng.standard_normal((b, n, m.qk_rope_dim))
    pos[:, :n] = np.arange(n)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    outs = {}
    for absorb in (False, True):
        cache = {"c_kv": torch.from_numpy(c_kv.copy()), "k_rope": torch.from_numpy(k_rope.copy()),
                 "pos": torch.from_numpy(pos.copy())}
        with both_flags(attention_impl=impl, mla_absorb=absorb):
            outs[absorb], _ = attn_mod.mla_decode(tp, torch.from_numpy(x), n, cache, cfg)
            if not absorb:
                ref, _ = jax.jit(lambda p, x, c: jax_attn.mla_decode(p, x, n, c, cfg))(
                    {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                    {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope),
                     "pos": jnp.asarray(pos)})
    assert _rel(outs[False].numpy(), ref) < REL_TOL
    assert _rel(outs[False].numpy(), outs[True].numpy()) < REL_TOL


# ---------------------------------------------------------------- mamba


def _mamba_case():
    cfg = jax_get_arch("mamba2-1.3b").reduced()
    tree = nontrivial({"m": jax.tree.map(np.array, jax_mamba.init_mamba(
        jax.random.PRNGKey(2), cfg, jnp.float32))})["m"]
    x = np.random.default_rng(8).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    return cfg, tree, x


@pytest.mark.parametrize("override", [8, 32, 0])
def test_mamba_chunk_override_matches_the_reference(override):
    """`ssm_chunk_override` in both packages (0 keeps the config's 16; 8
    divides the 40 steps; 32 pads them to 64): the output and the final
    state."""
    cfg, tree, x = _mamba_case()
    with both_flags(ssm_chunk_override=override):
        ref, ref_state = jax.jit(lambda p, x: jax_mamba.mamba_forward(p, x, cfg, return_state=True))(
            {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
        y, state = mamba_mod.mamba_forward({k: torch.from_numpy(v) for k, v in tree.items()},
                                           torch.from_numpy(x), cfg, return_state=True)
    assert _rel(y.numpy(), ref) < 1e-5
    assert _rel(state["ssm"].numpy(), ref_state["ssm"]) < 1e-5


def test_mamba_per_chunk_remat_gives_the_same_gradients(monkeypatch):
    """`ssm_chunk_remat` on and off, inside the per-super-block remat of
    `lm_loss` and without it: the loss and every gradient bitwise equal
    on the CPU, and the chunk checkpoints taken only when it is on."""
    cfg = get_arch("mamba2-1.3b").reduced()
    jcfg = jax_get_arch("mamba2-1.3b").reduced()
    tree = nontrivial(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg)))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 41))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    taken = []
    real = mamba_mod.checkpoint
    monkeypatch.setattr(mamba_mod, "checkpoint", lambda *a, **k: taken.append(1) or real(*a, **k))
    runs = {}
    for remat in (True, False):
        for chunk_remat in (True, False):
            model = from_jax(tree, cfg, device="cpu")
            model.requires_grad_(True)
            taken.clear()
            with both_flags(ssm_chunk_remat=chunk_remat):
                loss, _ = lm_loss(model, batch, remat=remat)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            assert bool(taken) == chunk_remat, (remat, chunk_remat)
            runs[remat, chunk_remat] = [loss.detach()] + list(grads)
    base = runs[False, False]
    for key, run in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(run, base)), key


# ------------------------------------------------------ sharding, prefill


BASELINE_SHARDED = ("gemma3-1b", "mamba2-1.3b")


@pytest.fixture(scope="module")
def reference_baseline_shardings():
    """The reference's `shard_params` and `shard_params_for_inference`
    under `set_baseline()` on the 16 x 16 mesh (256 forced devices, in a
    subprocess): {arch: {builder: {path: [spec, shard shape]}}}."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=256",
               PYTHONPATH=os.path.join(_ROOT, "src"), JAX_PLATFORMS="cpu")
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.configs.base import get_arch
        from repro.distributed import sharding as shd
        from repro.launch import specs as S
        from repro.models import runtime_flags

        runtime_flags.set_baseline()
        mesh = jax.make_mesh((16, 16), ("data", "model"))
        out = {{}}
        for arch in {list(BASELINE_SHARDED)!r}:
            params = S.param_shapes(get_arch(arch))
            out[arch] = {{}}
            for name, fn in (("params", shd.shard_params),
                             ("inference", shd.shard_params_for_inference)):
                sh = fn(params, mesh)
                rows = {{}}
                for (p, x), (_, s) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                          jax.tree_util.tree_flatten_with_path(sh)[0]):
                    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                    spec = [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]
                    rows[key] = [spec, list(s.shard_shape(x.shape))]
                out[arch][name] = rows
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", BASELINE_SHARDED)
def test_baseline_builders_match_the_reference(reference_baseline_shardings, arch):
    """`fsdp_min_tree_bytes == 0` shards every tree 2-D: each leaf's spec
    and per-card shape are the reference's under its baseline; under the
    default flags the same small trees are TP only (the flag is read)."""
    cfg = get_arch(arch)
    m = shd.Mesh({"data": 16, "model": 16}, logical=True)
    params = S.reference_layout(dict(S.param_shapes(cfg).named_parameters()), cfg)
    with both_flags("baseline"):
        got = {"params": shd.shard_params(params, m),
               "inference": shd.shard_params_for_inference(params, m)}
    default = shd.tree_bytes_per_card(shd.shard_params(params, m))
    for builder, shards in got.items():
        want = reference_baseline_shardings[arch][builder]
        assert sorted(shards) == sorted(want), builder
        for path, leaf in shards.items():
            spec = [list(e) if isinstance(e, tuple) else e for e in leaf.spec]
            assert [spec, list(leaf.card_shape)] == want[path], (builder, path)
        assert shd.tree_bytes_per_card(shards) < default, builder


def test_prefill_takes_context_parallel_attention_by_the_reference_rule():
    """Outside the baseline, heads that do not divide the mesh's model
    axis (reduced gemma3's 4 on 16 x 16) prefill through the chunked path
    (no flash call); on one card, or under the baseline, no CP."""
    cfg = get_arch("gemma3-1b").reduced()
    shape = ShapeConfig("tiny_prefill", 32, 2, "prefill")
    flash = {}
    for impl in ("optimized", "baseline"):
        for mesh in ("1", "16x16"):
            with dryrun.impl_flags(impl):
                rec = dryrun.lower_cell(cfg, shape, mesh=mesh)
            flash[impl, mesh] = rec["kernel_calls"].get("flash_attention", 0)
            assert rec["flags"]["attention_impl"] == ("chunked" if impl == "baseline" else "flash")
    assert flash == {("optimized", "1"): cfg.n_layers, ("optimized", "16x16"): 0,
                     ("baseline", "1"): 0, ("baseline", "16x16"): 0}
    assert port_flags.FLAGS.attention_impl == "flash" and not port_flags.FLAGS.attention_cp_axis
