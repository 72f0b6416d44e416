"""Every arch of `tests/test_torch_train.py`'s `ARCHS`, `.reduced()` in
bf16 (each registered config's own dtype): the port's `lm_loss` and every
gradient, from `from_jax` of the reference's bf16 tree, against
`jax.value_and_grad` of the reference's bf16 `lm_loss`.

The reference runs as the port trains (`test_torch_train_bf16.
reference_as_the_port_trains`, `compiled`: jitted with XLA's excess
precision off), at its bf16 P default, its SiLU and mamba conv in f32
rounded once, its bf16 einsums summed in f32.  The
constant-drawn leaves get seeded values first (`_torch_params.
nontrivial`), as in the fp32 test; the reference runs without remat (the
same values, recomputed or not).  With experts, the routing is compared
first, call by call: a top-k flip -- another expert set for a token, or
another top-1, which the aux loss reads -- fails the test by itself, it
is never absorbed into a gradient tolerance.  An order flip below the
top-1 within the same set (deepseek-v3's MTP block at `.reduced()` routes
every token to all 8 of its 8 experts; two tokens order two experts
0.0006 apart the other way) changes no slot, gate or sum.

The archs are split over this file and `test_torch_train_bf16_archs2.py`
(`check_arch`), so that the two run on two workers.

Tolerances (max abs error over max |ref|): the loss rel 1e-2, each
gradient leaf rel 2e-2 of its own max |grad| -- both sides round to bf16
at the same cast points and sum in other orders, so values land an ulp
(2^-8) apart now and then, and those ulps add up through the stack and
back (the forward's logits are held at 2e-2 in `tests/test_torch_bf16.py`
for the same reason).  A leaf past 2e-2 was traced (PERF.md): its
fp32 gradient matches at 1e-4 (`tests/test_torch_train.py`), and in bf16
the port and the reference each sit further from their own f32 gradient
of the same weights than from each other, the port no further than the
reference -- summation order, no cast.  12 leaves of 4 archs miss so
(PERF.md lists them: 2.01e-2 to 2.97e-2).  Such a leaf is held three
ways: within `MISS_TOL` of the matching reference; and, as the logits
are against the reference's default path in `tests/test_torch_bf16.py`,
against the reference as it runs by itself (jitted at XLA's defaults,
its jnp conv and bf16 SiLU and einsums) within the distance between the
reference's own two bf16 paths plus 2e-2, that distance itself under
`DEFAULT_PATH_TOL` (0.15; measured 0.0323 to 0.1177 at these leaves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import init_lm as jax_init_lm
from repro.models.lm import lm_loss as jax_lm_loss
from repro.models.runtime_flags import overrides
from repro_torch.configs import get_arch
from repro_torch.models import from_jax, lm_loss
from repro_torch.models import moe as moe_mod

from _torch_params import nontrivial  # the seeded constant-drawn leaves
from test_torch_train import ARCHS, _batch, _d_src, _torch_batch
from test_torch_bf16 import DEFAULT_PATH_TOL
from test_torch_train_bf16 import _rel, compiled, reference_as_the_port_trains

LOSS_TOL = 1e-2
GRAD_TOL = 2e-2
MISS_TOL = 4e-2  # a leaf past GRAD_TOL, against the matching reference


def _cfgs(name: str):
    return (dataclasses.replace(jax_get_arch(name).reduced(), dtype="bfloat16"),
            dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16"))


def _default_path_grads(jcfg, params, batch):
    """The reference's bf16 gradient tree as it runs by itself: jitted, as
    its train step is, unpatched, at its default bf16 P."""
    with overrides(flash_p_dtype="bfloat16"):
        return jax.jit(jax.grad(lambda p: jax_lm_loss(
            p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)[0]))(params)


def _reference(jcfg, params, batch, eager: bool = False):
    """The reference's bf16 loss, metrics and gradient tree, and the top-k
    expert ids of each MoE call in call order; `compiled`, or run eagerly
    (`eager`, for the readings below)."""
    ids = []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, idx = top_k(x, k)
        # a callback, in program order: the ids are not concrete until the
        # compiled function runs
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    jax.lax.top_k = recording_top_k
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    f = jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, jbatch, remat=False), has_aux=True)
    try:
        with reference_as_the_port_trains(eager):
            out = f(params) if eager else compiled(f, params)(params)
    finally:
        jax.lax.top_k = top_k
    (loss, metrics), grads = out
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, ids


def _bf16_tree(jcfg):
    """The reference's bf16 init tree (seed 0) with its constant-drawn
    leaves seeded, as numpy arrays."""
    return nontrivial(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), jcfg)))


def check_arch(name: str) -> dict:
    """`name` `.reduced()` in bf16: the routing, the loss and every
    gradient against the reference's (module docstring).  Returns the
    readings: the loss's rel error, the worst leaf's, and each leaf past
    `GRAD_TOL` with (its error, its error against the reference's default
    path, the reference's own two paths' distance)."""
    jcfg, cfg = _cfgs(name)
    tree = _bf16_tree(jcfg)
    batch = _batch(cfg.vocab_size, d_src=_d_src(cfg))
    jtree = jax.tree.map(jnp.asarray, tree)
    ref_loss, ref_metrics, ref_grads, ref_ids = _reference(jcfg, jtree, batch)

    model = from_jax(tree, cfg, device="cpu")
    model.requires_grad_(True)
    with moe_mod.record_routing() as routes:
        loss, metrics = lm_loss(model, _torch_batch(batch))
    if cfg.moe is not None:  # the routing first: a flip is a failure of its own
        assert routes and len(ref_ids) == len(routes), (len(routes), len(ref_ids))
        for i, r in enumerate(routes):
            ids = r.ids.numpy()
            assert np.array_equal(np.sort(ids, -1), np.sort(ref_ids[i], -1)), (name, "set", i)
            assert np.array_equal(ids[:, 0], ref_ids[i][:, 0]), (name, "top-1", i)
    assert loss.dtype == torch.float32
    assert _rel(float(loss.detach()), ref_loss) < LOSS_TOL, name
    assert set(metrics) == set(ref_metrics)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want = dict(from_jax(jax.tree.map(np.asarray, ref_grads), cfg, device="cpu")
                .named_parameters())
    assert set(names) == set(want)
    missed = {}
    for n, g in zip(names, grads):
        assert g.dtype == want[n].dtype, (name, n)
        err = _rel(g, want[n])
        assert err < MISS_TOL, (name, n, err)
        if err >= GRAD_TOL:
            missed[n] = g
    if missed:  # the reference's two paths' distance + 2e-2 (module docstring)
        default = dict(from_jax(jax.tree.map(np.asarray, _default_path_grads(jcfg, jtree, batch)),
                                cfg, device="cpu").named_parameters())
        for n, g in missed.items():
            port, own = _rel(g, default[n]), _rel(want[n], default[n])
            assert own < DEFAULT_PATH_TOL, (name, n, own)
            assert port <= own + GRAD_TOL, (name, n, _rel(g, want[n]), port, own)
            missed[n] = (_rel(g, want[n]), port, own)
    worst = max((_rel(g, want[n]), n) for n, g in zip(names, grads))
    return dict(loss=_rel(float(loss.detach()), ref_loss), worst=worst, missed=missed,
                tree=(jcfg, jtree, batch, want))


@pytest.mark.parametrize("name", ARCHS[:5])
def test_lm_loss_and_every_gradient_in_bf16_match_the_reference(name):
    check_arch(name)


def eager_distance(jcfg, jtree, batch, want, cfg) -> tuple:
    """The compiled reference's gradients (`want`, by name) against the
    same reference run eagerly: the worst leaf's rel distance and the
    number of leaves bitwise equal."""
    eager = dict(from_jax(jax.tree.map(np.asarray, _reference(jcfg, jtree, batch, eager=True)[2]),
                          cfg, device="cpu").named_parameters())
    return (max(_rel(want[n], e) for n, e in eager.items()),
            sum(torch.equal(want[n], e) for n, e in eager.items()), len(eager))


if __name__ == "__main__":  # the readings PERF.md quotes: PYTHONPATH=src:tests python <this file>
    import sys

    with_eager = "--eager" in sys.argv
    for arch in [a for a in sys.argv[1:] if a != "--eager"] or ARCHS:
        r = check_arch(arch)
        line = (f"{arch}: loss rel {r['loss']:.2e}; worst leaf {r['worst'][1]} "
                f"{r['worst'][0]:.4f}; {len(r['missed'])} past {GRAD_TOL}")
        if with_eager:
            d, same, n = eager_distance(*r["tree"], _cfgs(arch)[1])
            line += f"; compiled vs eager reference: worst {d:.4f}, {same} of {n} leaves bitwise"
        print(line, flush=True)
        for n, (err, port, own) in sorted(r["missed"].items()):
            print(f"  {n}: {err:.4f} against the matching reference, {port:.4f} against the "
                  f"default path, the reference's own distance {own:.4f}", flush=True)
