"""bf16 through the port's ConvNet path against the reference's, on the
CPU: `conv2d_fused_tile` on bf16 inputs (Winograd and FFT, against the
reference's matrix path and its Pallas kernel in interpret mode), bf16
`ConvSpec`s through the planner, and bf16 `Engine`s serving whole nets.

Both packages take bf16 in and give bf16 out; the tile engine computes
in f32 between (the padded input cast up, the output rounded once).  An
output passes when every element is within one bf16 ulp of the
reference's (at the reference's magnitude), or, where the two f32 sums
round to neighbouring bf16 values through a net's layers, within rel
1e-2 overall.

The materializing three-stage baseline (`three_stage`, the last layer of
vgg_mixed_channel's and resnet_downsample's plans) is the one place the
packages part in bf16: the reference's Winograd transform computes in
the input dtype, its basis matrices rounded to bf16 (`_mats`), where the
port's stages compute in f32 like its tile kernel.  The port's output is
held closer to the float64 result than the reference's, and no further.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import convserve as ref_cs
from repro.configs import convnets as ref_nets
from repro.core import analysis as ref_analysis
from repro.core import conv2d as ref_conv2d
from repro.core import registry as ref_registry
from repro.core import transforms as ref_tr
from repro.kernels import fused_tile as ref_ft
from repro_torch import convserve as cs
from repro_torch.configs import convnets as nets
from repro_torch.core import analysis, conv2d, registry, transforms
from repro_torch.core.device import dtype_name
from repro_torch.kernels.fused_tile import conv2d_fused_tile

REL_TOL = 1e-2  # overall, where an element's sum rounds the other way


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _bf16_pair(a: np.ndarray):
    """The same bf16 values for both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy()).to(torch.bfloat16)
    return j, t


def _as64(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32), np.float64)


def _ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _check(got, want) -> tuple:
    g, w = _as64(got), _as64(want)
    assert g.shape == w.shape
    diff = np.abs(g - w)
    in_ulp = bool((diff <= _ulp(w)).all())
    rel = float(diff.max() / (np.abs(w).max() + 1e-30))
    assert in_ulp or rel < REL_TOL, (rel, int((diff > _ulp(w)).sum()))
    return in_ulp, rel


def _pair(family):
    if family == "winograd":
        return ref_tr.WinogradTransform(m=3, k=3), transforms.WinogradTransform(m=3, k=3)
    return ref_tr.FFTTransform(t=8, k=3), transforms.FFTTransform(t=8, k=3)


@pytest.mark.parametrize("ref_backend", ("xla", "pallas_interpret"))
@pytest.mark.parametrize("scenario", ("plain", "grouped", "ragged", "bias_relu"))
@pytest.mark.parametrize("family", ("winograd", "fft"))
def test_fused_tile_takes_bf16(family, scenario, ref_backend):
    ref_tr_, tr = _pair(family)
    rng = np.random.default_rng(21)
    groups = 2 if scenario == "grouped" else 1
    h, w = (13, 11) if scenario == "ragged" else (14, 14)
    xj, xt = _bf16_pair(rng.standard_normal((2, h, w, 4)) * 0.5)
    wj, wt = _bf16_pair(rng.standard_normal((3, 3, 4 // groups, 6)) * 0.3)
    ref_ep = ep = None
    if scenario == "bias_relu":
        bj, bt = _bf16_pair(rng.standard_normal(6) * 0.1)
        ref_ep = ref_registry.ElementwiseOps((("bias", bj), ("relu",)))
        ep = registry.ElementwiseOps((("bias", bt), ("relu",)))
    want = ref_ft.conv2d_fused_tile(xj, wj, ref_tr_, pad=1, groups=groups, epilogue=ref_ep,
                                    backend=ref_backend)
    got = conv2d_fused_tile(xt, wt, tr, pad=1, groups=groups, epilogue=ep, device="cpu")
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _check(got, want)


SPECS = [
    dict(h=32, w=32, c_in=3, c_out=64, k=3, pad=1),
    dict(h=56, w=56, c_in=64, c_out=64, k=3, pad=1),
    dict(h=16, w=16, c_in=256, c_out=256, k=3, pad=1),
    dict(h=16, w=16, c_in=32, c_out=64, k=3, pad=1, stride=2, groups=4),
    dict(h=1, w=300, c_in=48, c_out=48, k=4, pad=3, groups=48),
]


_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)


@pytest.mark.parametrize("hw", ("skylake", "big"))
def test_bf16_convspec_plans_as_the_reference(hw):
    ref_hw, port_hw = {"skylake": (ref_analysis.SKYLAKE_X, analysis.SKYLAKE_X),
                       "big": (ref_analysis.HardwareModel(**_BIG),
                               analysis.HardwareModel(**_BIG))}[hw]
    for kw in SPECS:
        ref = ref_registry.plan_conv(ref_registry.ConvSpec(**kw, dtype="bfloat16"), ref_hw)
        got = registry.plan_conv(registry.ConvSpec(**kw, dtype="bfloat16"), port_hw)
        assert got.spec.dtype == "bfloat16"
        assert (got.algo, got.params) == (ref.algo, ref.params), kw
        assert got.predicted_util == pytest.approx(ref.predicted_util)
    for net in ("vgg_mixed_channel", "fft_fewchannel", "resnext_grouped"):
        ref = ref_cs.plan_net(getattr(ref_nets, net)(), 32, 32, hw=ref_hw, dtype="bfloat16")
        got = cs.plan_net(getattr(nets, net)(), 32, 32, hw=port_hw, dtype="bfloat16")
        assert got.to_json() == ref.to_json()


def _engines(net: str):
    ref_spec, spec = getattr(ref_nets, net)(), getattr(nets, net)()
    ref_ws = ref_cs.init_weights(ref_spec, seed=0)
    ref_net = ref_cs.Engine(hw=ref_analysis.SKYLAKE_X, dtype=jnp.bfloat16).compile(
        ref_spec, {i: w.astype(jnp.bfloat16) for i, w in ref_ws.items()}, input_hw=(32, 32))
    port_ws = {i: w.to(torch.bfloat16) for i, w in cs.from_jax(ref_ws, "cpu").items()}
    net_ = cs.Engine(hw=analysis.SKYLAKE_X, dtype=torch.bfloat16, device="cpu").compile(
        spec, port_ws, input_hw=(32, 32))
    assert net_.plan.to_json() == ref_net.plan.to_json()
    assert net_.describe() == ref_net.describe()
    c_in = spec.conv_layers()[0][1].c_in
    xj, xt = _bf16_pair(np.random.default_rng(1).standard_normal((2, 32, 32, c_in)) * 0.5)
    return ref_net, net_, xj, xt, port_ws


@pytest.mark.parametrize("net", ("tiny_testnet", "fft_fewchannel", "resnext_grouped"))
def test_bf16_engine_serves_as_the_reference(net):
    ref_net, net_, xj, xt, _ = _engines(net)
    assert "three_stage" not in net_.plan.algos()
    want, got = ref_net(xj), net_(xt)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _check(got, want)
    srv = cs.ConvServer(net_, cs.ConvServeConfig(max_batch=2, buckets=(32,)))
    out = srv.run([cs.ImageRequest(i, xt[i].float().numpy()) for i in range(2)])
    for i in range(2):
        assert np.array_equal(out[i], got[i].float().numpy())


@pytest.mark.parametrize("net", ("vgg_mixed_channel", "resnet_downsample"))
def test_bf16_three_stage_rounds_less_than_the_reference(net):
    """The fused layers' prefix as the reference's; the last layer's
    three-stage output no farther from float64 than the reference's."""
    ref_net, net_, xj, xt, port_ws = _engines(net)
    assert net_.plan.algos()[-1] == "three_stage"
    want, got = _as64(ref_net(xj)), _as64(net_(xt))
    spec = getattr(nets, net)()
    exact = cs.run_direct(spec, {i: w.double() for i, w in port_ws.items()},
                          xt.double()).numpy()
    err = lambda y: float(np.abs(y - exact).max() / np.abs(exact).max())
    assert err(got) <= err(want), (err(got), err(want))
    # the same layer alone, on the same bf16 input: the reference's bf16
    # basis is what parts them
    rng = np.random.default_rng(4)
    xj1, xt1 = _bf16_pair(rng.standard_normal((2, 16, 16, 32)) * 0.5)
    wj1, wt1 = _bf16_pair(rng.standard_normal((3, 3, 32, 32)) * 0.2)
    exact1 = torch.nn.functional.conv2d(
        xt1.double().permute(0, 3, 1, 2), wt1.double().permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1).numpy()
    e = lambda y: float(np.abs(_as64(y) - exact1).max() / np.abs(exact1).max())
    port1 = conv2d(xt1, wt1, pad=1, algo="three_stage", device="cpu")
    ref1 = ref_conv2d(xj1, wj1, pad=1, algo="three_stage")
    assert dtype_name(port1.dtype) == str(ref1.dtype) == "bfloat16"
    assert e(port1) < e(ref1)
