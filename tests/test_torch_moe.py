"""The port's mixture-of-experts layer (`repro_torch.models.moe`) against
the reference's (`repro.models.moe`).

The same seeded numpy weights and inputs go through both `moe_forward`s
on the CPU: the output, `moe_aux` and `moe_z`, and the gradient of a
seeded scalar of all three with respect to x and every parameter
(`jax.grad` on the reference's side).  Cases: moonshot-v1-16b-a3b and
deepseek-v3-671b at `.reduced()` (deepseek's has a shared expert and
routes to all 8 of 8), capacity forced to bite (`capacity_factor` 0.5,
given to both packages), a skewed batch of identical rows (the pad
tokens of a right-aligned wave: they all pick the same experts and fill
them first), and a decode-shaped (B, 1, D) input.  At `.reduced()`
capacity is 48 = N, so without the forced factor nothing could drop.

Which pairs the reference keeps is read off its own output with probe
weights (`_probe`): with x[:, 0] = 1, every expert maps any token to a
constant times the unit vector of its own index, so out[t, e] > 0
exactly where (token t, expert e) holds a slot.

Tolerances: rel 1e-5 (max abs error over max |ref|) for the output and
the aux losses, rel 1e-4 for every gradient leaf (both f32, the combine
summed in another order: the reference scatter-adds in expert order,
the port sums over the k choices).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import init_lm as jax_init_lm
from repro.models import moe as jax_moe
from repro_torch.configs import get_arch
from repro_torch.models import from_jax, init_lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Params

OUT_REL = 1e-5
GRAD_REL = 1e-4


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _cfgs(name, capacity_factor=None):
    """(reference config, port config): `name` reduced, the same MoE
    capacity factor given to both when one is named."""
    out = []
    for get in (jax_get_arch, get_arch):
        cfg = get(name).reduced()
        if capacity_factor is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return tuple(out)


def _inputs(kind, d, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "decode":
        return rng.standard_normal((3, 1, d)).astype(np.float32)
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    if kind == "pads":  # right-aligned prompts of 6 and 12 over one pad token
        x[0, :18] = x[0, 0]
        x[1, :12] = x[0, 0]
    return x


CASES = {
    # name: (arch, capacity factor or None, input kind)
    "moonshot": ("moonshot-v1-16b-a3b", None, "plain"),
    "deepseek-v3-shared-expert-top8": ("deepseek-v3-671b", None, "plain"),
    "capacity-0.5-drops": ("moonshot-v1-16b-a3b", 0.5, "plain"),
    "pads-at-capacity-0.5": ("moonshot-v1-16b-a3b", 0.5, "pads"),
    "decode-B3": ("moonshot-v1-16b-a3b", None, "decode"),
}


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg,
                                                     jnp.float32))


def _port(cfg, p, x, cot, *, grads=True):
    """The port's output, aux losses and (with `grads`) the gradient of
    sum(out * cot) + moe_aux + moe_z by name, with its routing."""
    tp = Params({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    tp.requires_grad_(grads)
    xt = torch.from_numpy(x.copy()).requires_grad_(grads)
    with moe_mod.record_routing() as routes:
        out, aux = moe_mod.moe_forward(tp, xt, cfg)
    g = {}
    if grads:
        scalar = (out * torch.from_numpy(cot)).sum() + aux["moe_aux"] + aux["moe_z"]
        names, leaves = zip(*tp.named_parameters())
        got = torch.autograd.grad(scalar, (xt, *leaves))
        g = {"x": got[0].numpy(), **{n: t.numpy() for n, t in zip(names, got[1:])}}
    return out.detach().numpy(), {k: float(v.detach()) for k, v in aux.items()}, g, routes[0]


def _reference(jcfg, p, x, cot):
    def f(p, x):
        out, aux = jax_moe.moe_forward(p, x, jcfg)
        return jnp.sum(out * cot) + aux["moe_aux"] + aux["moe_z"], (out, aux)

    jp = jax.tree.map(jnp.asarray, p)
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    g = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}
    return np.asarray(out), {k: float(v) for k, v in aux.items()}, g


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_and_gradients_match_jax(case):
    arch, factor, kind = CASES[case]
    jcfg, cfg = _cfgs(arch, factor)
    p = _weights(jcfg)
    x = _inputs(kind, cfg.d_model)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    out, aux, g, r = _port(cfg, p, x, cot)
    ref, ref_aux, ref_g = _reference(jcfg, p, x, cot)
    assert out.shape == ref.shape == x.shape
    assert _rel(out, ref) < OUT_REL, case
    for k in ("moe_aux", "moe_z"):
        assert abs(aux[k] - ref_aux[k]) <= OUT_REL * abs(ref_aux[k]), (case, k)
    assert set(g) == set(ref_g) == {"x", *p}
    for k in g:
        assert g[k].shape == ref_g[k].shape, (case, k)
        assert _rel(g[k], ref_g[k]) < GRAD_REL, (case, k)
    n = x.shape[0] * x.shape[1]
    assert r.cap == jax_moe.capacity(n, jcfg.moe) == moe_mod.capacity(n, cfg.moe)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (factor is not None), (case, dropped)


def _probe(p, e):
    """Weights under which, for x[:, 0] = 1, expert i returns
    silu(1) * e_i: w1 and w3 read only x[:, 0], w2 writes only column i."""
    q = dict(p)
    q["w1"] = np.zeros_like(p["w1"])
    q["w1"][:, 0, :] = 1.0
    q["w3"] = q["w1"].copy()
    q["w2"] = np.zeros_like(p["w2"])
    for i in range(e):
        q["w2"][i, 0, i] = 1.0
    return q


@pytest.mark.parametrize("kind", ["pads", "plain"])
def test_kept_pairs_are_the_reference_slots(kind):
    """At capacity factor 0.5 (cap 24 for 48 tokens x 6 choices over 8
    experts) pairs drop; the pairs the port keeps (its routing's `keep`)
    are exactly those the reference's output shows kept under probe
    weights, and the port's output under those weights is the
    reference's.  With the pad tokens (30 identical rows, flat positions
    0-17 and 24-35) their six experts fill in flat order: row 0's 18 pads
    hold a slot at each, row 0's 6 real tokens may take the rest, and row
    1's pads from flat position 30 on find every one full."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", 0.5)
    e = cfg.moe.n_experts
    p = _probe(_weights(jcfg, seed=3), e)
    x = _inputs(kind, cfg.d_model, seed=4)
    x[..., 0] = 1.0
    ref = np.asarray(jax_moe.moe_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)[0])
    out, _, _, r = _port(cfg, p, x, None, grads=False)
    assert _rel(out, ref) < OUT_REL
    ref_kept = ref.reshape(-1, cfg.d_model)[:, :e] > 0
    kept = np.zeros_like(ref_kept)
    ids, keep = r.ids.numpy(), r.keep.numpy()
    for t in range(ids.shape[0]):
        kept[t, ids[t][keep[t]]] = True
    assert (ref_kept == kept).all()
    assert 0 < kept.sum() < ids.size  # some pairs dropped, some kept
    if kind == "pads":
        pads = np.r_[0:18, 24:36]
        assert (ids[pads] == ids[0]).all()  # identical rows, identical experts
        assert keep[:18].all() and not keep[30:36].any()
        assert (kept[:, ids[0]].sum(axis=0) == r.cap).all()  # the pads' experts are full


def test_slots_are_unique_and_in_flat_order():
    """Every kept pair holds its own slot of its expert's block, and
    within an expert the slots follow flat (token, choice) order (the
    stable sort); dropped pairs point at the overflow row E * cap."""
    _, cfg = _cfgs("moonshot-v1-16b-a3b", 0.5)
    rng = np.random.default_rng(7)
    router = torch.tensor(rng.standard_normal((cfg.d_model, cfg.moe.n_experts)),
                          dtype=torch.float32)
    xt = torch.tensor(rng.standard_normal((40, cfg.d_model)), dtype=torch.float32)
    r = moe_mod.route({"router": router}, xt, cfg.moe)
    e, cap = cfg.moe.n_experts, r.cap
    slot, ids, keep = r.slot.reshape(-1), r.ids.reshape(-1), r.keep.reshape(-1)
    assert (slot[~keep] == e * cap).all()
    assert len(set(slot[keep].tolist())) == int(keep.sum())
    assert ((slot[keep] // cap) == ids[keep]).all()
    for i in range(e):
        mine = slot[ids == i]
        assert (mine[:cap] == i * cap + torch.arange(min(cap, len(mine)))).all()
        assert (mine[cap:] == e * cap).all()


def test_init_moe_draws_the_reference_distributions():
    """`w1` / `w3` at std 1/sqrt(n_experts) -- the reference's
    `dense_init` with its default fan-in, the leading axis -- `w2` at
    1/sqrt(d_ff), the f32 router at 1/sqrt(d_model); each a normal
    truncated at 2 std (std factor 0.8796), as the reference's draws."""
    jcfg, cfg = (dataclasses.replace(c, d_model=128, d_ff=64) for c in _cfgs(
        "moonshot-v1-16b-a3b"))
    gen = torch.Generator().manual_seed(0)
    ours = moe_mod.init_moe(gen, cfg, torch.float32, "cpu")
    ref = _weights(jcfg)
    trunc = 0.8796
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    for name, fan_in in (("w1", e), ("w3", e), ("w2", f), ("router", d)):
        assert ours[name].dtype == torch.float32 and tuple(ours[name].shape) == ref[name].shape
        want = trunc / np.sqrt(fan_in)
        assert abs(float(ours[name].std()) / want - 1) < 0.03, name
        assert abs(float(ref[name].std()) / want - 1) < 0.03, name
        assert float(ours[name].abs().max()) <= 2 / np.sqrt(fan_in) * (1 + 1e-6), name
    assert abs(float(ours["w1"].std()) * np.sqrt(e) - trunc) < 0.03  # 1/sqrt(E), not 1/sqrt(d)


def test_init_moe_draws_shared_experts():
    _, cfg = _cfgs("deepseek-v3-671b")
    ours = moe_mod.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    fs = cfg.d_ff * cfg.moe.n_shared
    assert tuple(ours["shared_w1"].shape) == (cfg.d_model, fs)
    assert tuple(ours["shared_w2"].shape) == (fs, cfg.d_model)
    ref = _weights(_cfgs("deepseek-v3-671b")[0])
    assert set(ours) == set(ref)


def test_from_jax_carries_the_moe_subtree():
    """The reference's moonshot tree loaded with `from_jax`: each layer's
    ``moe`` leaves (router in f32) equal the reference's, by layer."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    params = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg))
    model = from_jax(params, cfg, device="cpu")
    stacked = params["stack"][0]["layers"][0]["moe"]
    assert all(s.moe for s in model.specs) and len(model.layers) == cfg.n_layers
    for i, lp in enumerate(model.layers):
        assert "mlp" not in lp
        assert sorted(n for n, _ in lp["moe"].named_parameters()) == sorted(stacked)
        assert lp["moe"]["router"].dtype == torch.float32
        for k, v in stacked.items():
            np.testing.assert_array_equal(lp["moe"][k].numpy(), v[i])


def test_init_lm_builds_moonshot_and_still_refuses_mla_and_enc_dec():
    model = init_lm(get_arch("moonshot-v1-16b-a3b").reduced(), seed=0, device="cpu")
    assert sorted(n for n, _ in model.layers[0].named_parameters()) == [
        "attn.wk", "attn.wo", "attn.wq", "attn.wv", "ln1", "ln2", "moe.router", "moe.w1",
        "moe.w2", "moe.w3"]
    for name in ("deepseek-v3-671b", "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_lm(get_arch(name).reduced(), seed=0, device="cpu")


def test_record_routing_collects_one_entry_per_moe_call():
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    model = init_lm(cfg, seed=0, device="cpu")
    from repro_torch.models import lm_logits

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    with moe_mod.record_routing() as routes:
        lm_logits(model, toks)
    assert len(routes) == cfg.n_layers
    assert all(tuple(r.ids.shape) == (18, cfg.moe.top_k) and not r.ids.requires_grad
               for r in routes)
    lm_logits(model, toks)
    assert len(routes) == cfg.n_layers  # nothing recorded outside the block
