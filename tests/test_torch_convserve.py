"""The port's planner, ConvNet engine and server (`repro_torch`) against
the reference package (`repro`), on the CPU.

The same `HardwareModel` numbers must give the same plans (algorithms,
params, fusion groups); a v3 plan JSON written by the reference must
load unchanged and serve the same outputs (rel < 1e-4: both run the
same algorithms in fp32, in different summation orders); weights drawn
from one seed must be equal bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import convserve as ref_cs
from repro.configs import convnets as ref_nets
from repro.core import analysis as ref_analysis
from repro.core import registry as ref_registry
from repro_torch import convserve as cs
from repro_torch.configs import convnets as nets
from repro_torch.core import analysis, conv2d, registry, transforms, tune
from repro_torch.kernels.fused_tile import conv2d_fused_tile

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
HWS = {
    "skylake": (ref_analysis.SKYLAKE_X, analysis.SKYLAKE_X),
    "big": (ref_analysis.HardwareModel(**_BIG), analysis.HardwareModel(**_BIG)),
}
NETS = ("tiny_testnet", "fft_fewchannel", "resnext_grouped")
SERVE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    """Both packages plan from the model alone: an empty wisdom file."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _rel(y, ref):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))


def _c_in(spec):
    return spec.conv_layers()[0][1].c_in


SPECS = [
    dict(h=32, w=32, c_in=3, c_out=64, k=3, pad=1),
    dict(h=56, w=56, c_in=64, c_out=64, k=3, pad=1),
    dict(h=16, w=16, c_in=256, c_out=256, k=3, pad=1),
    dict(h=32, w=32, c_in=4, c_out=8, k=3, pad=1),
    dict(h=16, w=16, c_in=32, c_out=64, k=3, pad=1, stride=2, groups=4),
    dict(h=4, w=4, c_in=8, c_out=8, k=3, pad=1),
]


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("idx", range(len(SPECS)))
def test_plan_conv_matches_reference(hw, idx):
    ref_hw, port_hw = HWS[hw]
    for hints in ({}, {"m": 5, "t_fft": 16}):
        ref = ref_registry.plan_conv(ref_registry.ConvSpec(**SPECS[idx]), ref_hw, hints=hints)
        got = registry.plan_conv(registry.ConvSpec(**SPECS[idx]), port_hw, hints=hints)
        assert (got.algo, got.params) == (ref.algo, ref.params)
        assert got.predicted_util == pytest.approx(ref.predicted_util)


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("net", NETS + ("vgg_mixed_channel",))
def test_plan_net_matches_reference(net, hw):
    ref_hw, port_hw = HWS[hw]
    spec = getattr(nets, net)()
    ref_spec = getattr(ref_nets, net)()
    for size in (16, 32):
        ref = ref_cs.plan_net(ref_spec, size, size, hw=ref_hw)
        got = cs.plan_net(spec, size, size, hw=port_hw)
        assert got.to_json() == ref.to_json()
        assert cs.lower(spec, got).describe() == ref_cs.lower(ref_spec, ref).describe()


@pytest.mark.parametrize("net", NETS)
def test_compiled_net_matches_reference_for_same_plan(net):
    """A v3 plan written by the reference loads unchanged into the port
    and serves the same outputs from the same weights."""
    ref_hw, _ = HWS["big"]
    ref_spec, spec = getattr(ref_nets, net)(), getattr(nets, net)()
    ref_ws = ref_cs.init_weights(ref_spec, seed=2)
    ref_net = ref_cs.Engine(hw=ref_hw).compile(ref_spec, ref_ws, input_hw=(16, 16))
    plan = cs.NetPlan.from_json(ref_net.plan.to_json())
    port_net = cs.Engine(device="cpu").compile(
        spec, cs.from_jax(ref_ws, "cpu"), plan=plan, fuse=None
    )
    assert port_net.describe() == ref_net.describe()
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 16, 16, _c_in(spec))) * 0.1).astype(np.float32)
    y = port_net(torch.from_numpy(x))
    assert y.device.type == "cpu"
    assert _rel(y.numpy(), ref_net(jnp.asarray(x))) < SERVE_TOL


def test_ragged_server_matches_reference():
    spec, ref_spec = nets.tiny_testnet(4), ref_nets.tiny_testnet(4)
    ref_hw, port_hw = HWS["big"]
    cfg = dict(max_batch=2, buckets=(8, 16))
    ref_ws = ref_cs.init_weights(ref_spec, seed=0)
    ref_net = ref_cs.Engine(hw=ref_hw).compile(ref_spec, ref_ws, input_hw=(16, 16))
    port_net = cs.Engine(hw=port_hw, device="cpu").compile(
        spec, cs.init_weights(spec, seed=0), input_hw=(16, 16)
    )
    assert port_net.describe() == ref_net.describe()
    rng = np.random.default_rng(9)
    imgs = [(rng.standard_normal((s, s, 4)) * 0.1).astype(np.float32)
            for s in (16, 8, 12, 16, 4)]
    ref_srv = ref_cs.ConvServer(ref_net, ref_cs.ConvServeConfig(**cfg))
    srv = cs.ConvServer(port_net, cs.ConvServeConfig(**cfg))
    want = ref_srv.run([ref_cs.ImageRequest(i, im) for i, im in enumerate(imgs)])
    got = srv.run([cs.ImageRequest(i, im) for i, im in enumerate(imgs)])
    assert sorted(got) == sorted(want)
    for rid in want:
        assert isinstance(got[rid], np.ndarray)
        assert got[rid].shape == want[rid].shape
        assert _rel(got[rid], want[rid]) < SERVE_TOL, rid
    rs, ps = ref_srv.stats(), srv.stats()
    for key in ("waves", "partial_waves", "admitted"):
        assert ps[key] == rs[key], key
    assert ps["cache"]["hits"] == rs["cache"]["hits"]


@pytest.mark.parametrize("net", NETS + ("vgg_mixed_channel",))
def test_init_weights_bitwise_equal(net):
    ref_ws = ref_cs.init_weights(getattr(ref_nets, net)(), seed=4)
    ws = cs.init_weights(getattr(nets, net)(), seed=4)
    assert sorted(ws) == sorted(ref_ws)
    for i, w in ws.items():
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_ws[i]))


def test_from_jax_round_trips():
    ref_ws = ref_cs.init_weights(ref_nets.fft_fewchannel(4), seed=1)
    ws = cs.from_jax(ref_ws, "cpu")
    for i, w in ref_ws.items():
        assert ws[i].device.type == "cpu"
        np.testing.assert_array_equal(ws[i].numpy(), np.asarray(w))
    back = cs.from_jax({i: w.numpy() for i, w in ws.items()}, "cpu")
    for i in ws:
        assert torch.equal(back[i], ws[i])


def _engine():
    return cs.Engine()


def _conv2d():
    return conv2d(np.zeros((1, 8, 8, 2), np.float32), np.zeros((3, 3, 2, 2), np.float32), pad=1)


def _tile():
    return conv2d_fused_tile(
        np.zeros((1, 8, 8, 2), np.float32), np.zeros((3, 3, 2, 2), np.float32),
        transforms.WinogradTransform(m=3, k=3), pad=1,
    )


@pytest.mark.parametrize("entry", (_engine, _conv2d, _tile), ids=lambda f: f.__name__)
def test_entry_point_without_device_raises_on_cuda_less_host(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_wisdom_reads_only_the_ports_own_keys(tmp_path, monkeypatch):
    """Planning reads R and block shapes from a `torch-<device>:` wisdom
    entry and ignores the reference's `cpu:` entry for the same layer,
    so one $REPRO_WISDOM file can serve both packages."""
    spec = registry.ConvSpec(h=32, w=32, c_in=4, c_out=8, k=3, pad=1)
    tr = transforms.WinogradTransform(m=5, k=3)
    geom = f"winograd:32x32x4->8:k3:t{tr.t}"
    path = tmp_path / "wisdom.json"
    path.write_text(json.dumps({
        f"cpu:{geom}": {"r": 48},
        f"{tune._backend()}:{geom}": {"r": 16, "blocks": {"r": 16, "tpp": 2, "mix": 4}},
    }))
    monkeypatch.setenv("REPRO_WISDOM", str(path))
    assert tune.lookup_r(32, 32, 4, 8, transform=tr) == 16
    assert tune.lookup_blocks(32, 32, 4, 8, transform=tr).tasks_per_program == 2
    ap = registry.plan_conv(spec, HWS["big"][1], algo="l3_fused", hints={"m": 5})
    assert ap.tuned and ap.params["r_tiles"] == 16
    assert ap.params["blocks"] == {"r": 16, "tpp": 2, "mix": 4}


def test_plan_file_round_trip(tmp_path):
    plan = cs.plan_net(nets.fft_fewchannel(4), 32, 32, hw=HWS["big"][1])
    plan.save(tmp_path / "net.plan.json")
    back = cs.NetPlan.load(tmp_path / "net.plan.json")
    assert back == plan and back.groups
