"""Training in the port against the reference: `lm_loss` and its
gradients, AdamW, the train step (microbatched or not), the loop's fault
handling and the launcher.

Weights are the reference's `init_lm` tree loaded with `from_jax`; data
and optimizer state are seeded numpy arrays handed to both.  Leaves that
the reference draws as constants -- zamba2's `lora_*_b` (zeros: a fresh
LoRA adds nothing and its `lora_*_a` get no gradient) and the three
`lora_*_a` (one draw, equal), mamba's `A_log`, `dt_bias` and `D` -- are
set to seeded non-trivial values in the numpy tree fed to both
(`_torch_params.nontrivial`).  The
reference runs with P in f32 (`tests/conftest.py` sets it), as the port
keeps P.

Tolerances: loss rel 1e-5 and every gradient leaf rel 1e-4 (max abs
error over max |ref|; both f32, summed in other orders through the
stack); AdamW on identical inputs 1e-6 (params and f32 / bf16 moments),
an int8 moment within one quantisation step of its block; multi-step
runs by their loss at rel 1e-4 -- not by parameters: AdamW's first steps
turn a gradient at rounding-noise level into a full +-lr step.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.models import init_lm as jax_init_lm
from repro.models.lm import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.runtime.fault import FailureInjector as JaxFailureInjector
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import train_loop as jax_train_loop
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models import from_jax, lm_loss
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig, make_train_step, train_state

from _torch_params import nontrivial  # the seeded constant-drawn leaves

LOSS_REL = 1e-5
GRAD_REL = 1e-4
ADAM_ATOL = 1e-6
STEP_LOSS_REL = 1e-4
ARCHS = ("gemma3-1b", "stablelm-3b", "mamba2-1.3b", "zamba2-7b", "qwen2.5-14b",
         "deepseek-67b", "chameleon-34b", "moonshot-v1-16b-a3b")


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


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


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """(name, jax params, batch, jax loss, port model of jax grads)."""
    name = request.param
    cfg = jax_get_arch(name).reduced()
    params = jax.tree.map(jnp.asarray, nontrivial(
        jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg))))
    batch = _batch(cfg.vocab_size)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    np_params = jax.tree.map(np.asarray, params)
    g_model = from_jax(jax.tree.map(np.asarray, grads), get_arch(name).reduced(), device="cpu")
    return name, np_params, batch, float(loss), {k: float(v) for k, v in metrics.items()}, g_model


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_every_gradient_match_jax(reference, remat):
    name, np_params, batch, ref_loss, ref_metrics, g_model = reference
    model = from_jax(np_params, get_arch(name).reduced(), device="cpu")
    model.requires_grad_(True)
    loss, metrics = lm_loss(model, _torch_batch(batch), remat=remat)
    assert set(metrics) == set(ref_metrics)
    assert _rel(float(loss.detach()), ref_loss) < LOSS_REL
    for k in ("nll", "moe_aux", "moe_z"):
        assert abs(float(metrics[k].detach()) - ref_metrics[k]) <= LOSS_REL * abs(ref_metrics["loss"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want = dict(g_model.named_parameters())
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        assert _rel(g.numpy(), want[n].detach().numpy()) < GRAD_REL, (name, n)


@pytest.mark.parametrize("reference", ["zamba2-7b"], indirect=True)
def test_zamba2_shared_and_lora_gradients_by_name(reference):
    """zamba2's shared attention and MLP leaves take a gradient summed over
    the stack's two invocations, and each invocation's LoRA leaves one of
    their own: every one is non-zero and matches the reference's leaf of
    the same name (`test_lm_loss_and_every_gradient_match_jax` holds the
    rest)."""
    name, np_params, batch, _, _, g_model = reference
    model = from_jax(np_params, get_arch(name).reduced(), device="cpu")
    assert [s.mixer for s in model.specs].count("shared_attn") == 2
    model.requires_grad_(True)
    loss, _ = lm_loss(model, _torch_batch(batch))
    named = dict(model.named_parameters())
    want = dict(g_model.named_parameters())
    shared = [f"shared.attn.{w}" for w in ("wq", "wk", "wv", "wo")] + [
        f"shared.mlp.{w}" for w in ("w1", "w3", "w2")]
    lora = [f"layers.{i}.lora_{t}_{ab}" for i in (0, 3) for t in "qkv" for ab in "ab"]
    grads = torch.autograd.grad(loss, [named[n] for n in shared + lora])
    for n, g in zip(shared + lora, grads):
        ref = want[n].detach().numpy()
        assert np.abs(ref).max() > 0 and g.abs().max() > 0, n
        assert _rel(g.numpy(), ref) < GRAD_REL, n


@pytest.mark.parametrize("reference", ["moonshot-v1-16b-a3b"], indirect=True)
@pytest.mark.parametrize("remat", [True, False])
def test_moonshot_aux_losses_and_router_gradients(reference, remat):
    """moonshot's `moe_aux` and `moe_z` are the sums over its four MoE
    layers (each within rel 1e-5 of the reference's, not just of the
    loss), and every layer's f32 router takes a non-zero gradient that
    matches the reference's."""
    name, np_params, batch, _, ref_metrics, g_model = reference
    model = from_jax(np_params, get_arch(name).reduced(), device="cpu")
    model.requires_grad_(True)
    loss, metrics = lm_loss(model, _torch_batch(batch), remat=remat)
    for k in ("moe_aux", "moe_z"):
        assert ref_metrics[k] > 0
        assert abs(float(metrics[k].detach()) - ref_metrics[k]) <= LOSS_REL * ref_metrics[k], k
    named = dict(model.named_parameters())
    routers = [n for n in named if n.endswith("moe.router")]
    assert len(routers) == len(model.specs) == 4
    want = dict(g_model.named_parameters())
    for n, g in zip(routers, torch.autograd.grad(loss, [named[n] for n in routers])):
        assert named[n].dtype == torch.float32 and g.abs().max() > 0, n
        assert _rel(g.numpy(), want[n].detach().numpy()) < GRAD_REL, n


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_reaches_every_parameter(name):
    cfg = jax_get_arch(name).reduced()
    model = from_jax(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1), cfg)),
                     get_arch(name).reduced(), device="cpu")
    model.requires_grad_(True)
    loss, _ = lm_loss(model, _torch_batch(_batch(cfg.vocab_size, seed=1)))
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# ------------------------------------------------------------------ AdamW


def _adam_inputs(moment_dtype, seed=0):
    """Seeded params (a matrix, a ragged matrix for int8's padding, a
    vector that takes no weight decay), grads and nonzero moments at step
    count 4, in the reference's form."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 32), "r": (7, 45), "b": (37,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    m = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in shapes.items()}
    v = {k: rng.random(s).astype(np.float32) * 0.5 for k, s in shapes.items()}
    cfg = jax_adamw.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    st = jax_adamw.adamw_init(jp, cfg)
    if moment_dtype == "int8":
        st["m"] = {k: jax_adamw._q8_encode(jnp.asarray(x)) for k, x in m.items()}
        st["v"] = {k: jax_adamw._q8_encode(jnp.sqrt(jnp.asarray(x))) for k, x in v.items()}
    else:
        st["m"] = {k: jnp.asarray(x).astype(moment_dtype) for k, x in m.items()}
        st["v"] = {k: jnp.asarray(x).astype(moment_dtype) for k, x in v.items()}
    st["count"] = jnp.asarray(4, jnp.int32)
    return cfg, jp, {k: jnp.asarray(x) for k, x in grads.items()}, st


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_the_reference_on_identical_inputs(moment_dtype):
    cfg, jp, jg, jst = _adam_inputs(moment_dtype)
    lr_scale = 0.7
    rp, rst, rmet = jax_adamw.adamw_update(jp, jg, jst, cfg, lr_scale)

    tcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    params = {k: _to_torch(x) for k, x in jp.items()}
    grads = {k: _to_torch(x) for k, x in jg.items()}
    st = {"m": _to_torch(jst["m"]), "v": _to_torch(jst["v"]),
          "count": torch.tensor(4, dtype=torch.int32)}
    p_out, st_out, met = adamw.adamw_update(params, grads, st, tcfg, lr_scale)
    assert p_out is params and int(st_out["count"]) == 5
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) < 1e-5 * float(rmet["grad_norm"])
    assert abs(float(met["clip"]) - float(rmet["clip"])) < ADAM_ATOL
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rp[k]), rtol=0, atol=ADAM_ATOL)
        for mom, sqrt_domain in (("m", False), ("v", True)):
            ours, ref = st_out[mom][k], rst[mom][k]
            if moment_dtype == "int8":
                dec = adamw._q8_decode(ours, params[k]).numpy()
                ref_dec = np.asarray(jax_adamw._q8_decode(ref, params[k].shape, params[k].numel()))
                step = np.repeat(np.asarray(ref["scale"]), 256)[: params[k].numel()]
                assert np.all(np.abs(dec - ref_dec).reshape(-1) <= step * (1 + 1e-6)), (k, mom)
            else:
                assert ours.dtype == getattr(torch, moment_dtype)
                np.testing.assert_allclose(ours.float().numpy(),
                                           np.asarray(ref).astype(np.float32),
                                           rtol=0, atol=ADAM_ATOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_init_matches_the_reference(moment_dtype):
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    st = adamw.adamw_init({"w": torch.zeros(3, 300)}, cfg)
    ref = jax_adamw.adamw_init({"w": jnp.zeros((3, 300))}, jax_adamw.AdamWConfig(
        moment_dtype=moment_dtype))
    assert int(st["count"]) == 0
    if moment_dtype == "int8":
        assert tuple(st["m"]["w"]["q"].shape) == ref["m"]["w"]["q"].shape
        assert st["m"]["w"]["q"].dtype == torch.int8
    else:
        assert st["v"]["w"].dtype == getattr(torch, moment_dtype)


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 101, 2500, 9999, 10000, 12000])
def test_warmup_cosine_matches_the_reference(step):
    ours = float(adamw.warmup_cosine(step, warmup=100, total=10000))
    ref = float(jax_adamw.warmup_cosine(jnp.asarray(step, jnp.int32), warmup=100, total=10000))
    assert abs(ours - ref) <= 1e-7
    ours_t = adamw.warmup_cosine(torch.tensor(step, dtype=torch.int32), peak=2.0, warmup=7,
                                 total=300)
    ref_t = jax_adamw.warmup_cosine(jnp.asarray(step, jnp.int32), peak=2.0, warmup=7, total=300)
    assert abs(float(ours_t) - float(ref_t)) <= 2e-7


def test_global_norm_matches_the_reference():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (100,), (2, 5, 7))]
    ours = float(adamw.global_norm(torch.from_numpy(x) for x in xs))
    ref = float(jax_adamw.global_norm([jnp.asarray(x) for x in xs]))
    assert abs(ours - ref) <= 1e-6 * ref


# ------------------------------------------------------------- train step


def _pair(name="gemma3-1b", microbatches=1, lr=3e-4):
    jcfg = jax_get_arch(name).reduced()
    jt = JaxTrainConfig(optimizer=jax_adamw.AdamWConfig(lr=lr), microbatches=microbatches,
                        warmup_steps=2, total_steps=20)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    cfg = get_arch(name).reduced()
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=lr), microbatches=microbatches,
                       warmup_steps=2, total_steps=20)
    state = train_state(from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu"),
                        tcfg)
    return (jcfg, jt, jstate), (cfg, tcfg, state)


def test_three_steps_match_the_reference_by_loss():
    (jcfg, jt, jstate), (cfg, tcfg, state) = _pair()
    stream = JaxTokenStream(JaxDataConfig(jcfg.vocab_size, 32, 4, seed=0))
    jstep = jax.jit(jax_make_train_step(jcfg, jt))
    step = make_train_step(cfg, tcfg)
    for t in range(3):
        batch = stream.batch_at(t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert _rel(float(m["loss"]), float(jm["loss"])) < STEP_LOSS_REL, t
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) < GRAD_REL, t
        assert set(m) == set(jm)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_two_microbatches_match_one_and_the_reference():
    (jcfg, jt, jstate), (cfg, tcfg, state) = _pair(microbatches=2)
    _, (_, tcfg1, state1) = _pair(microbatches=1)
    batch = JaxTokenStream(JaxDataConfig(jcfg.vocab_size, 32, 4, seed=1)).batch_at(0)
    _, m2 = make_train_step(cfg, tcfg)(state, batch)
    _, m1 = make_train_step(cfg, tcfg1)(state1, batch)
    _, jm = jax.jit(jax_make_train_step(jcfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(m2) == set(jm) == {"loss", "grad_norm", "clip"}
    assert _rel(float(m2["loss"]), float(m1["loss"])) < LOSS_REL
    assert _rel(float(m2["grad_norm"]), float(m1["grad_norm"])) < GRAD_REL
    assert _rel(float(m2["loss"]), float(jm["loss"])) < LOSS_REL
    assert _rel(float(m2["grad_norm"]), float(jm["grad_norm"])) < GRAD_REL


# -------------------------------------------------------------- the loop


def _toy_steps():
    """tests/test_fault.py's toy regression, in both frameworks."""
    def jstep(state, batch):
        w = state["params"]["w"]
        x, y = batch["x"], batch["y"]
        loss = jnp.mean((x @ w - y) ** 2)
        g = jax.grad(lambda ww: jnp.mean((x @ ww - y) ** 2))(w)
        return ({"params": {"w": w - 0.1 * g}, "step": state["step"] + 1},
                {"loss": loss, "grad_norm": jnp.linalg.norm(g)})

    def tstep(state, batch):
        w = state["params"]["w"].clone().requires_grad_(True)
        x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        return ({"params": {"w": (w - 0.1 * g).detach()}, "step": state["step"] + 1},
                {"loss": loss.detach(), "grad_norm": torch.linalg.norm(g)})

    return jax.jit(jstep), tstep


def _toy_batches():
    w_true = np.random.default_rng(0).standard_normal((4, 1))

    def next_batch(step):
        x = np.random.default_rng(step).standard_normal((16, 4)).astype(np.float32)
        return {"x": x, "y": (x @ w_true).astype(np.float32)}

    return next_batch


def test_loop_recovers_from_injected_failures_as_the_reference(tmp_path, capsys):
    jstep, tstep = _toy_steps()
    cfgs = dict(total_steps=20, ckpt_every=5, log_every=100)
    ref_inj, inj = JaxFailureInjector(fail_at_steps=(7, 13)), FailureInjector(fail_at_steps=(7, 13))
    ref = jax_train_loop(
        state={"params": {"w": jnp.zeros((4, 1))}, "step": jnp.int32(0)}, train_step=jstep,
        next_batch=_toy_batches(), cfg=JaxLoopConfig(ckpt_dir=str(tmp_path / "ref"), **cfgs),
        injector=ref_inj)
    ref_out = capsys.readouterr().out
    final = train_loop(
        state={"params": {"w": torch.zeros(4, 1)}, "step": torch.tensor(0, dtype=torch.int32)},
        train_step=tstep, next_batch=_toy_batches(),
        cfg=LoopConfig(ckpt_dir=str(tmp_path / "ours"), **cfgs), injector=inj)
    out = capsys.readouterr().out
    assert inj.fired == ref_inj.fired == {7, 13}
    assert out.count("[fault]") == ref_out.count("[fault]") == 2
    assert int(final["step"]) == int(ref["step"])
    np.testing.assert_allclose(final["params"]["w"].numpy(), np.asarray(ref["params"]["w"]),
                               rtol=1e-5, atol=1e-6)
    assert sorted(p.name for p in (tmp_path / "ours").glob("step_*.done")) == sorted(
        p.name for p in (tmp_path / "ref").glob("step_*.done"))


def test_loop_resumes_from_disk_as_the_reference(tmp_path):
    jstep, tstep = _toy_steps()
    for ckpt, loop, state0, step_fn in (
        (tmp_path / "ref", (jax_train_loop, JaxLoopConfig),
         {"params": {"w": jnp.zeros((4, 1))}, "step": jnp.int32(0)}, jstep),
        (tmp_path / "ours", (train_loop, LoopConfig),
         {"params": {"w": torch.zeros(4, 1)}, "step": torch.tensor(0, dtype=torch.int32)}, tstep),
    ):
        run, cfg = loop
        run(state=state0, train_step=step_fn, next_batch=_toy_batches(),
            cfg=cfg(total_steps=10, ckpt_dir=str(ckpt), ckpt_every=4, log_every=100))
        assert ckpt_io.latest_step(ckpt) == 9
        final = run(state=state0, train_step=step_fn, next_batch=_toy_batches(),
                    cfg=cfg(total_steps=12, ckpt_dir=str(ckpt), ckpt_every=4, log_every=100))
        assert int(final["step"]) == 12


def test_loop_reports_every_step_and_saves_on_sigterm(tmp_path):
    _, tstep = _toy_steps()
    seen = []

    def on_step(step, metrics, dt):
        seen.append((step, float(metrics["loss"]), dt))
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    final = train_loop(
        state={"params": {"w": torch.zeros(4, 1)}, "step": torch.tensor(0, dtype=torch.int32)},
        train_step=tstep, next_batch=_toy_batches(),
        cfg=LoopConfig(total_steps=50, ckpt_dir=str(tmp_path), ckpt_every=100, log_every=100),
        on_step=on_step, log=lambda s: None)
    assert [s for s, _, _ in seen] == [0, 1, 2, 3]
    assert all(np.isfinite(loss) and dt >= 0 for _, loss, dt in seen)
    assert int(final["step"]) == 4
    assert ckpt_io.latest_step(tmp_path) == 3


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    state, history = launch_train.main([
        "--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    assert int(state["step"]) == 3
    assert state["params"].embed.device.type == "cpu"
    out = capsys.readouterr().out
    assert "[train] arch=gemma3-1b" in out and "step      0 loss" in out
    assert ckpt_io.latest_step(tmp_path) == 2


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_launcher_trains_the_ssm_stacks_on_the_cpu(tmp_path, arch, capsys):
    """mamba2 and zamba2 (shared attention + LoRA) train `--reduced` through
    the launcher, with a checkpoint that holds zamba2's shared leaves."""
    state, history = launch_train.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--seq", "40", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    assert f"[train] arch={arch}" in capsys.readouterr().out
    assert ckpt_io.latest_step(tmp_path) == 1
    names = dict(state["params"].named_parameters())
    assert ("shared.mlp.w1" in names) == (arch == "zamba2-7b")


def test_launcher_trains_moonshot_on_the_cpu(tmp_path, capsys):
    """moonshot-v1-16b-a3b (`--reduced`: 4 MoE layers, 8 experts, top-6)
    trains through the launcher; each step's history holds its summed
    aux losses, finite and non-zero."""
    state, history = launch_train.main([
        "--arch", "moonshot-v1-16b-a3b", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "40", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [h["step"] for h in history] == [0, 1]
    for h in history:
        assert all(np.isfinite(h[k]) for k in ("loss", "grad_norm", "moe_aux", "moe_z"))
        assert h["moe_aux"] > 0 and h["moe_z"] > 0
    assert "[train] arch=moonshot-v1-16b-a3b" in capsys.readouterr().out
    assert ckpt_io.latest_step(tmp_path) == 1
    assert "layers.3.moe.router" in dict(state["params"].named_parameters())


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "gemma3-1b", "--reduced", "--steps", "1"])
