"""Training in bf16, every registered config's own dtype, against the JAX
reference in bf16 on the CPU: the plain flash backward at bf16 P, the
plain conv1d backward at bf16, AdamW's bf16 update, the train step and
the launcher.  Run as a script it prints the readings PERF.md quotes.
Each arch's bf16 loss and every gradient are in
`tests/test_torch_train_bf16_archs.py`, which shares this file's
reference harness (`reference_as_the_port_trains`).

The reference runs as the port runs it, as in `tests/test_torch_bf16.py`
(whose `_reference` this extends): at its bf16 P default, its SiLU in
f32, its bf16 einsums on f32 copies, and its mamba conv + bias + SiLU in
f32 rounded once (`_conv1d_f32`), as the port's conv1d and its gradient
compute it: the reference's default jnp conv rounds after every multiply
and add (`test_conv1d_bwd_ref_against_the_reference_default_path` gives
that distance).  It is jitted and compiled with XLA's excess precision
off (`compiled`), so that every bf16 cast its source writes is kept, as
when it runs eagerly (`tests/test_torch_bf16.py` runs it eagerly): under
the default `xla_allow_excess_precision` XLA keeps f32 through fused
bf16 chains.  Compiled so, its gradients sit within 8.6e-3 of the eager
ones (zamba2-7b; `tests/test_torch_train_bf16_archs.py --eager`,
PERF.md), and it runs several times sooner.

Tolerances (max abs error over max |ref|): the plain kernels' functions
rel 1e-2 -- both sides compute in f32 and round each gradient once, so
they part by at most an ulp (2^-8) where a sum rounds the other way;
the conv1d gradient against float64 rel 1e-2 (one rounding, 2^-9).
AdamW on the same bf16 parameters and gradients: every element within
one bf16 rounding a step of the reference's, at most `ADAMW_MOVED` of
them on another bf16 (the two sides' f32 expressions part in the last
place).
Three train steps at the launcher's lr 3e-3: a step's loss rel 1e-2;
after the steps, every leaf that did not start at zero rel 2e-2 of its
max |p| (a 3e-3 step is a few bf16 ulps of a weight), and every leaf's
update (the parameters after the steps less before) by its L2 norm at
rel `STEP_UPDATE_TOL`: Adam's first steps are nearly sign(g) lr, so a
gradient element near zero that the two sides' bf16 sums leave on
opposite signs moves by 2 lr (measured 5.4e-2 at worst, PERF.md).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.conv1d_fused as jax_conv1d_pkg
from repro.configs import get_arch as jax_get_arch
from repro.core.conv import conv1d_depthwise_causal
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.models import flash_attention as jax_flash
from repro.models import init_lm as jax_init_lm
from repro.optim import adamw as jax_adamw
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.kernels.conv1d_fused import conv1d_bwd_ref
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import from_jax
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step, train_state

from test_torch_bf16 import BF16, _bf16, _f64, _reference, _rel, _t

KERNEL_TOL = 1e-2
ADAMW_MOVED = 1e-3
STEP_LOSS_TOL = 1e-2
STEP_PARAM_TOL = 2e-2
STEP_UPDATE_TOL = 7.5e-2
LR = 3e-3  # `launch.train`'s default
NO_EXCESS = {"xla_allow_excess_precision": False}


def _conv1d_f32(x, w, b=None, *, activation="silu", lb=128):
    """act(causal depthwise conv1d(x, w) + b) computed in f32 from the upcast
    inputs and rounded once to x's dtype: the reference's Pallas kernel's
    function, in jnp so that JAX differentiates it (its gradient is the
    f32 one, each input's gradient rounded once by the casts' transposes)."""
    xf = x.astype(jnp.float32)
    y = conv1d_depthwise_causal(xf, w.astype(jnp.float32))
    if b is not None:
        y = y + b.astype(jnp.float32)
    if activation == "silu":
        y = y * jax.lax.logistic(y)
    return y.astype(x.dtype)


@contextlib.contextmanager
def reference_as_the_port_trains(eager: bool = False):
    """`tests/test_torch_bf16.py`'s `_reference` with jit on, unless `eager`
    (bf16 P, SiLU in f32, bf16 einsums summed in f32, mamba's conv through
    the Pallas kernel's entry point), with that entry point computing
    `_conv1d_f32`, which JAX can differentiate.  Trace `compiled`
    functions under it."""
    saved = jax_conv1d_pkg.conv1d_fused
    jax_conv1d_pkg.conv1d_fused = _conv1d_f32
    try:
        with _reference(eager=eager):
            yield
    finally:
        jax_conv1d_pkg.conv1d_fused = saved


def compiled(fn, *args):
    """`fn` jitted for `args` and compiled with XLA's excess precision off:
    every bf16 cast in the traced source is kept."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


# ------------------------------------------------------------ flash backward

FLASH_CASES = {  # (b, sq, sk, hq, hkv, hd, vd, causal, window, blk)
    "hd64": (1, 64, 64, 4, 2, 64, 64, True, 0, 32),
    "mla-192-128": (1, 64, 64, 2, 2, 192, 128, True, 0, 32),
    "mtp-56": (1, 64, 64, 2, 2, 56, 56, True, 0, 32),
    "hd256-window": (1, 64, 64, 4, 1, 256, 256, True, 24, 16),
    "cross-sq32-sk64": (2, 32, 64, 2, 2, 64, 64, False, 0, 32),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_backward_matches_the_reference_at_bf16(case):
    """`flash_attention_bwd_ref` on bf16 inputs (its default bf16 P for dV)
    against the reference's `_flash_bwd` at `flash_p_dtype` bf16, both fed
    the reference forward's bf16 o and f32 lse: dq, dk, dv in bf16 within
    rel 1e-2."""
    b, sq, sk, hq, hkv, hd, vd, causal, window, blk = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q, k = _bf16(rng, (b, sq, hq, hd)), _bf16(rng, (b, sk, hkv, hd))
    v, do = _bf16(rng, (b, sk, hkv, vd)), _bf16(rng, (b, sq, hq, vd))
    qp = jnp.asarray(np.broadcast_to(np.arange(sq, dtype=np.float32), (b, sq)))
    kp = jnp.asarray(np.broadcast_to(np.arange(sk, dtype=np.float32), (b, sk)))

    def reference(q, k, v, do):
        o, lse, _ = jax_flash._flash_fwd_impl(q, k, v, qp, kp, causal, window, blk, blk,
                                              "bfloat16")
        grads = jax_flash._flash_bwd(causal, window, blk, blk, "bfloat16",
                                     (q, k, v, o, lse, qp, kp), do)[:3]
        return o, lse, grads

    args = tuple(jnp.asarray(a) for a in (q, k, v, do))
    with reference_as_the_port_trains():
        o, lse, want = compiled(reference, *args)(*args)

    def bhsd(a):
        return _t(a).transpose(1, 2)

    got = flash_attention_bwd_ref(bhsd(q), bhsd(k), bhsd(v), bhsd(np.asarray(o)),
                                  _t(np.asarray(lse)).reshape(b, hq, sq), bhsd(do),
                                  causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == BF16
        assert _rel(g.transpose(1, 2), w) < KERNEL_TOL, (case, name)


def test_plain_flash_backward_rounds_p_to_bf16_for_dv_only():
    """At bf16 inputs dv uses bf16(P) (the reference's `pc`) and dq / dk the
    f32 P; at `p_dtype` f32 dv moves and dq / dk do not."""
    rng = np.random.default_rng(4)
    q, k, v, do = (_t(_bf16(rng, (1, 2, 40, 16))) for _ in range(4))
    from repro_torch.kernels.flash_attention import attention_ref, lse_ref

    o, lse = attention_ref(q, k, v), lse_ref(q, k)
    bf = flash_attention_bwd_ref(q, k, v, o, lse, do)
    f32 = flash_attention_bwd_ref(q, k, v, o, lse, do, p_dtype=torch.float32)
    assert torch.equal(bf[0], f32[0]) and torch.equal(bf[1], f32[1])
    assert not torch.equal(bf[2], f32[2])


# ------------------------------------------------------------ conv1d backward


def _conv_inputs(seed=5, b=2, length=40, d=24, k=4):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (b, length, d)), _bf16(rng, (k, d), 0.5), _bf16(rng, (d,), 0.1),
            _bf16(rng, (b, length, d)))


def _conv_grad_f64(x, w, b, g):
    """The gradient of silu(conv + b) in float64 from the bf16 values."""
    xt, wt, bt = (torch.tensor(_f64(a), requires_grad=True) for a in (x, w, b))
    k, length = wt.shape[0], xt.shape[1]
    xp = torch.nn.functional.pad(xt, (0, 0, k - 1, 0))
    pre = sum(xp[:, i:i + length] * wt[i] for i in range(k)) + bt
    return torch.autograd.grad(torch.nn.functional.silu(pre), (xt, wt, bt),
                               torch.tensor(_f64(g)))


def test_conv1d_bwd_ref_at_bf16_against_float64():
    """`conv1d_bwd_ref` on bf16 inputs: f32 sums, each gradient rounded once
    to bf16, within rel 1e-2 of the float64 gradient (one rounding)."""
    x, w, b, g = _conv_inputs()
    got = conv1d_bwd_ref(_t(g), _t(x), _t(w), _t(b))
    for name, a, want in zip(("dx", "dw", "db"), got, _conv_grad_f64(x, w, b, g)):
        assert a.dtype == torch.bfloat16
        assert _rel(a, want) < KERNEL_TOL, name


# the reference's default jnp conv (each multiply and add rounded to bf16,
# XLA's bf16 SiLU) against the f32-then-round-once function the port and
# the reference's Pallas kernel compute: its gradient may part from the
# port's by this much of max |grad|, a few of its own per-op roundings
DEFAULT_PATH_TOL = 2e-2


def test_conv1d_bwd_ref_against_the_reference_default_path():
    """`conv1d_bwd_ref` at bf16 against XLA's gradient of the reference's
    `silu(conv1d_depthwise_causal(x, w) + b)` in bf16 (the path its mamba
    trains through): within `DEFAULT_PATH_TOL`, and no closer to float64
    than the port is -- the distance is the default path's per-op
    rounding, not the port's."""
    x, w, b, g = _conv_inputs()
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda x_, w_, b_: jax.nn.silu(conv1d_depthwise_causal(x_, w_) + b_),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        xla = vjp(jnp.asarray(g))
    got = conv1d_bwd_ref(_t(g), _t(x), _t(w), _t(b))
    f64 = _conv_grad_f64(x, w, b, g)
    for name, a, r, want in zip(("dx", "dw", "db"), got, xla, f64):
        assert r.dtype == BF16
        assert _rel(a, r) < DEFAULT_PATH_TOL, name
        assert _rel(a, want) <= _rel(r, want) + 2.0 ** -8, name


# ------------------------------------------------------------ the train step


def _bf16_gemma3():
    """gemma3-1b `.reduced()` in bf16 (its registered dtype) in both packages,
    and the reference's seeded init tree."""
    jcfg = dataclasses.replace(jax_get_arch("gemma3-1b").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("gemma3-1b").reduced(), dtype="bfloat16")
    return jcfg, cfg, jax_init_lm(jax.random.PRNGKey(0), jcfg)


def _bf16_pair(microbatches: int):
    """The reference's and the port's train state of gemma3-1b `.reduced()`
    in bf16 from one seeded tree, at lr `LR`."""
    jcfg, cfg, params = _bf16_gemma3()
    jt = JaxTrainConfig(optimizer=jax_adamw.AdamWConfig(lr=LR), microbatches=microbatches,
                        warmup_steps=2, total_steps=20)
    jstate = {"params": params, "opt": jax_adamw.adamw_init(params, jt.optimizer),
              "step": jnp.zeros((), jnp.int32)}
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=LR), microbatches=microbatches,
                       warmup_steps=2, total_steps=20)
    state = train_state(from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu"), tcfg)
    return (jcfg, jt, jstate), (cfg, tcfg, state)


ADAMW_STEPS = 3


def _adamw_steps():
    """The port's and the reference's bf16 parameters by name after
    `ADAMW_STEPS` AdamW steps from one gemma3-1b `.reduced()` tree on the
    same seeded bf16 gradients (norm 0.12, below the clip)."""
    jcfg, cfg, params = _bf16_gemma3()
    jc, pc = jax_adamw.AdamWConfig(lr=LR), adamw.AdamWConfig(lr=LR)
    jopt = jax_adamw.adamw_init(params, jc)
    jupdate = jax.jit(lambda p, g, o: jax_adamw.adamw_update(p, g, o, jc))
    have = dict(from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu").named_parameters())
    opt = adamw.adamw_init(have, pc)
    rng = np.random.default_rng(7)
    for _ in range(ADAMW_STEPS):
        grads = jax.tree.map(lambda p: jnp.asarray(_bf16(rng, p.shape, 2e-4)).astype(p.dtype),
                             params)
        params, jopt, jm = jupdate(params, grads, jopt)
        g = dict(from_jax(jax.tree.map(np.asarray, grads), cfg, device="cpu").named_parameters())
        _, opt, m = adamw.adamw_update(have, {n: t.detach() for n, t in g.items()}, opt, pc)
        assert float(jm["clip"]) == float(m["clip"]) == 1.0
    want = dict(from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu").named_parameters())
    return {n: t.detach() for n, t in have.items()}, {n: t.detach() for n, t in want.items()}


def _roundings(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in bf16 roundings of max(|b|, lr)."""
    return float(((a.double() - b.double()).abs()
                  / torch.clamp(b.double().abs(), min=LR)).max()) * 2.0 ** 8


def test_adamw_rounds_its_f32_update_into_bf16_as_the_reference():
    """The port's `adamw_update` and the reference's on the same bf16
    parameters and gradients (`_adamw_steps`): both update in f32, decay
    the matrices and round once a step to bf16, so every element lands
    within one bf16 rounding a step of the reference's (|a - b| <= 3 x
    2^-8 max(|b|, lr); measured 1.97 roundings, a zero-init norm scale)
    and at most `ADAMW_MOVED` of them on another bf16 (measured 3.5e-4,
    PERF.md)."""
    have, want = _adamw_steps()
    moved = total = 0
    for n, a in have.items():
        b = want[n]
        assert a.dtype == b.dtype == torch.bfloat16, n
        assert _roundings(a, b) <= ADAMW_STEPS, n
        moved += int((a != b).sum())
        total += a.numel()
    assert moved <= ADAMW_MOVED * total, (moved, total)


def _three_steps(microbatches: int):
    """Three train steps of gemma3-1b `.reduced()` in bf16 in both packages
    from one tree on `TokenStream` batches: [(port loss, reference loss)]
    a step, and the parameters by name before, after in the port and after
    in the reference (`compiled`)."""
    (jcfg, jt, jstate), (cfg, tcfg, state) = _bf16_pair(microbatches)
    p0 = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    stream = JaxTokenStream(JaxDataConfig(jcfg.vocab_size, 16, 4, seed=0))
    step, jstep, losses = make_train_step(cfg, tcfg), None, []
    for t in range(3):
        batch = stream.batch_at(t)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if jstep is None:
            with reference_as_the_port_trains():
                jstep = compiled(jax_make_train_step(jcfg, jt), jstate, jbatch)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        losses.append((float(m["loss"]), float(jm["loss"])))
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    have = {n: p.detach() for n, p in state["params"].named_parameters()}
    return losses, p0, have, {n: p.detach() for n, p in want.named_parameters()}


def _update_rel(p0: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """|(a - p0) - (b - p0)| / |b - p0| in L2: one leaf's update against the
    reference's."""
    got, ref = a.double() - p0.double(), b.double() - p0.double()
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_bf16_steps_match_the_reference(microbatches):
    """Three train steps of gemma3-1b `.reduced()` in bf16 (AdamW updating
    in f32, each parameter rounded to bf16) against the reference's
    `make_train_step` (`_three_steps`): the loss each step within rel
    1e-2, the parameters after the steps in bf16 on both and within the
    module docstring's tolerances, each leaf's update by its L2 norm."""
    losses, p0, have, want = _three_steps(microbatches)
    for t, (loss, ref) in enumerate(losses):
        assert _rel(loss, ref) < STEP_LOSS_TOL, t
    for n, p in want.items():
        assert have[n].dtype == p.dtype == torch.bfloat16, n
        if p0[n].any():  # (a leaf that started at zero is its updates: held by them below)
            assert _rel(have[n], p) < STEP_PARAM_TOL, n
        assert _update_rel(p0[n], have[n], p) < STEP_UPDATE_TOL, n


# ------------------------------------------------------------ the launcher


def test_launcher_trains_in_the_config_dtype():
    """`--reduced` trains the reduced config's own dtype, f32, as the
    reference's launcher does (its `reduced()` is f32); a bf16 config
    trains bf16 parameters: the launcher overrides no dtype."""
    state, _ = launch_train.main([
        "--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "1",
        "--batch", "2", "--seq", "16"])
    assert {p.dtype for p in state["params"].parameters()} == {torch.float32}


def test_launcher_trains_a_bf16_config_in_bf16(monkeypatch, capsys):
    """The registered configs are bf16 and the launcher trains them so:
    gemma3-1b at `.reduced()`'s widths kept in bf16 (its registered dtype;
    the flags name no dtype, as the reference's), two steps, finite loss,
    every floating parameter bf16 after AdamW's f32 update."""
    class _Bf16Reduced:
        def __init__(self, cfg):
            self.cfg = cfg

        def reduced(self):
            return dataclasses.replace(self.cfg.reduced(), dtype=self.cfg.dtype)

    monkeypatch.setattr(launch_train, "get_arch", lambda name: _Bf16Reduced(get_arch(name)))
    state, history = launch_train.main([
        "--arch", "gemma3-1b", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16"])
    assert get_arch("gemma3-1b").dtype == "bfloat16"
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)
    assert {p.dtype for p in state["params"].parameters()} == {torch.bfloat16}
    assert "bfloat16 on cpu" in capsys.readouterr().out


if __name__ == "__main__":  # the readings PERF.md quotes: PYTHONPATH=src:tests python <this file>
    have, want = _adamw_steps()
    moved = sum(int((a != want[n]).sum()) for n, a in have.items())
    total = sum(a.numel() for a in have.values())
    worst = max((_roundings(a, want[n]), n) for n, a in have.items())
    print(f"adamw: {moved} of {total} elements on another bf16 ({moved / total:.3e}); "
          f"worst {worst[0]:.3f} roundings at {worst[1]}")
    for mb in (1, 2):
        losses, p0, have, want = _three_steps(mb)
        upd = max((_update_rel(p0[n], have[n], p), n) for n, p in want.items())
        zero = max((_update_rel(p0[n], have[n], p), n) for n, p in want.items()
                   if not p0[n].any())
        par = max((_rel(have[n], p), n) for n, p in want.items() if p0[n].any())
        print(f"three steps, microbatches {mb}: loss rel "
              f"{', '.join(f'{_rel(a, b):.2e}' for a, b in losses)}; worst update L2 "
              f"{upd[0]:.4f} at {upd[1]} (zero-init {zero[0]:.4f} at {zero[1]}); worst "
              f"parameter {par[0]:.4f} at {par[1]}")
