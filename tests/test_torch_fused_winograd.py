"""The port's fused Winograd path (`repro_torch.kernels.fused_winograd`,
registry name `l3_fused_pallas`) and its f64 task-scan oracle
(`repro_torch.core.pipeline.scan_tile_conv`) against the reference's.

On the CPU `l3_fused_pallas` runs the tile kernel's plain version; it is
held against the reference's `conv2d_fused_pallas` in interpret mode at
F(2,3), F(4,3) and F(5,3), grouped and not, at rel < 5e-5 (the
reference's engine tolerance).  `scan_tile_conv` agrees with the
reference's in f32 (rel < 5e-5), and in f64 with the reference's staged
path in f64 (rel < 1e-12: the same per-tile arithmetic in double
precision, summed in another order; the reference's own scan does not
trace under x64).  f64 raises at the tile kernel's wrapper; on the CPU
it reaches the scan through `fused_tile_conv` by its dtype, counted in
`SCAN_CALLS`, and off the CPU it never does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.convnets import tiny_testnet as ref_tiny_testnet
from repro.convserve import Engine as RefEngine
from repro.convserve import init_weights as ref_init_weights
from repro.convserve.planner import plan_net as ref_plan_net
from repro.core import analysis as ref_analysis
from repro.core import pipeline as ref_pipeline
from repro.core import transforms as ref_tr
from repro.kernels.fused_winograd import conv2d_fused_pallas as ref_fused_pallas
from repro.kernels.fused_winograd import conv2d_ref as ref_conv2d_ref
from repro_torch.configs.convnets import tiny_testnet
from repro_torch.convserve import Engine, NetPlan, init_weights
from repro_torch.core import analysis, pipeline, registry, transforms
from repro_torch.kernels.fused_tile import UnsupportedSpec, conv2d_fused_tile
from repro_torch.kernels.fused_winograd import conv2d_fused_pallas, conv2d_ref

TOL = 5e-5  # the reference's engine tolerance (tests/test_fused_tile.py)
TOL_F64 = 1e-12
_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _operands(seed, *, b=2, h=12, w=12, c_in=4, c_out=6, groups=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c_in)) * 0.1).astype(dtype)
    wk = (rng.standard_normal((3, 3, c_in // groups, c_out)) * 0.1).astype(dtype)
    return x, wk


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("m", (2, 4, 5))
def test_l3_fused_pallas_matches_reference_interpret(m, groups):
    x, wk = _operands(m * 10 + groups, groups=groups)
    ref = ref_fused_pallas(
        jnp.asarray(x), jnp.asarray(wk), pad=1, m=m, r_tiles=8, groups=groups,
        interpret=True,
    )
    spec = registry.ConvSpec(h=12, w=12, c_in=4, c_out=6, k=3, pad=1, groups=groups)
    ap = registry.plan_conv(
        spec, analysis.SKYLAKE_X, algo="l3_fused_pallas",
        hints={"m": m, "r_tiles": 8},
    )
    assert ap.algo == "l3_fused_pallas" and ap.params["m"] == m
    alg = registry.get("l3_fused_pallas")
    y = alg.execute(torch.from_numpy(x), torch.from_numpy(wk), None, ap)
    assert _rel(y, ref) < TOL
    direct = conv2d_fused_pallas(
        torch.from_numpy(x), torch.from_numpy(wk), pad=1, m=m, r_tiles=8,
        groups=groups, device="cpu",
    )
    assert torch.equal(direct, y)


def test_l3_fused_pallas_is_explicit_only_and_mirrors_the_reference():
    alg = registry.get("l3_fused_pallas")
    assert not alg.auto_candidate and not alg.consumes_wt
    assert alg.chain_family == "winograd" and alg.weight_params == ()
    spec = registry.ConvSpec(h=16, w=16, c_in=8, c_out=8, k=3, pad=1)
    assert registry.plan_conv(spec, analysis.SKYLAKE_X).algo != "l3_fused_pallas"


def test_conv2d_ref_matches_reference():
    x, wk = _operands(3)
    ref = ref_conv2d_ref(jnp.asarray(x), jnp.asarray(wk), pad=1)
    y = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wk), pad=1)
    assert _rel(y, ref) < TOL


def _scan_pair(family):
    if family == "winograd":
        return ref_tr.WinogradTransform(m=4, k=3), transforms.WinogradTransform(m=4, k=3)
    return ref_tr.FFTTransform(t=8, k=3), transforms.FFTTransform(t=8, k=3)


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("family", ("winograd", "fft"))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_scan_tile_conv_matches_reference(dtype, family, groups):
    ref_t, tr = _scan_pair(family)
    x, wk = _operands(7, h=13, w=11, groups=groups, dtype=np.dtype(dtype))
    if dtype == "float32":
        ref = np.asarray(ref_pipeline.scan_tile_conv(
            jnp.asarray(x), jnp.asarray(wk), ref_t, pad=1, r_tiles=5, groups=groups,
        ))
    else:
        # the reference's scan cannot trace under x64 (its tile offsets
        # are int32 beside an int64 literal); its staged path runs the same
        # per-tile forward / multiply / inverse in f64, without the tasks
        with jax.enable_x64(True):
            ref = np.asarray(ref_pipeline.staged_tile_conv(
                jnp.asarray(x), jnp.asarray(wk), ref_t, pad=1, groups=groups,
            ))
    assert ref.dtype == np.dtype(dtype)
    before = pipeline.SCAN_CALLS
    y = pipeline.scan_tile_conv(
        torch.from_numpy(x), torch.from_numpy(wk), tr, pad=1, r_tiles=5, groups=groups,
    )
    assert pipeline.SCAN_CALLS == before + 1
    assert y.dtype == getattr(torch, dtype) and tuple(y.shape) == ref.shape
    assert _rel(y, ref) < (TOL_F64 if dtype == "float64" else TOL)


def test_scan_tile_conv_epilogue_runs_per_task():
    tr = transforms.WinogradTransform(m=4, k=3)
    x, wk = _operands(9)
    bvec = torch.linspace(-0.1, 0.1, 6)
    ep = registry.ElementwiseOps((("bias", bvec), ("relu",)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(wk)
    y = pipeline.scan_tile_conv(xt, wt, tr, pad=1, r_tiles=3, epilogue=ep)
    want = torch.relu(pipeline.scan_tile_conv(xt, wt, tr, pad=1, r_tiles=3) + bvec)
    assert _rel(y, want) < 1e-6


@pytest.mark.parametrize("family", ("winograd", "fft"))
def test_f64_raises_at_the_kernel_and_runs_through_the_scan(family):
    _, tr = _scan_pair(family)
    x, wk = _operands(13, dtype=np.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(wk)
    with pytest.raises(UnsupportedSpec, match="f64"):
        conv2d_fused_tile(xt, wt, tr, pad=1, device="cpu")
    before = pipeline.SCAN_CALLS
    y = pipeline.fused_tile_conv(xt, wt, tr, pad=1, r_tiles=5)
    assert pipeline.SCAN_CALLS == before + 1
    assert y.dtype == torch.float64
    direct = torch.nn.functional.conv2d(
        xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1,
    ).permute(0, 2, 3, 1)
    # the Winograd basis constants are f32-rounded, as in the reference's
    # f64 path (rel ~1e-7 at F(4,3)); the FFT's are exact in f64
    assert _rel(y, direct) < 1e-6
    # f32 never reaches the scan
    before = pipeline.SCAN_CALLS
    pipeline.fused_tile_conv(xt.float(), wt.float(), tr, pad=1, r_tiles=5)
    assert pipeline.SCAN_CALLS == before


@pytest.mark.parametrize("family", ("winograd", "fft"))
def test_f64_off_the_cpu_raises_instead_of_running_the_scan(family):
    """Only a CPU tensor may take the plain scan: an f64 tensor on another
    device (here `meta`, standing in for the card) reaches the kernel
    wrapper and raises, and the scan is not called."""
    _, tr = _scan_pair(family)
    x, wk = _operands(13, dtype=np.float64)
    xt, wt = torch.from_numpy(x).to("meta"), torch.from_numpy(wk).to("meta")
    before = pipeline.SCAN_CALLS
    with pytest.raises(UnsupportedSpec, match="f64"):
        pipeline.fused_tile_conv(xt, wt, tr, pad=1, r_tiles=5)
    assert pipeline.SCAN_CALLS == before


def test_plan_file_naming_l3_fused_pallas_loads_and_serves(tmp_path, monkeypatch):
    """A plan the reference saved with `l3_fused_pallas` layers loads in
    the port, verifies, compiles on the CPU and serves what the
    reference serves (rel < 5e-5)."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))
    ref_spec, spec = ref_tiny_testnet(4), tiny_testnet(4)
    ref_plan = ref_plan_net(ref_spec, 16, 16, hw=ref_analysis.HardwareModel(**_BIG))
    swapped = [
        dataclasses.replace(p, algo="l3_fused_pallas") if p.algo == "l3_fused" else p
        for p in ref_plan.layers
    ]
    assert any(p.algo == "l3_fused_pallas" for p in swapped)
    ref_plan = dataclasses.replace(ref_plan, layers=tuple(swapped))
    path = tmp_path / "net.plan.json"
    ref_plan.save(path)

    plan = NetPlan.load(path)
    assert plan.algos() == ref_plan.algos()
    net = Engine(hw=analysis.HardwareModel(**_BIG), device="cpu").compile(
        spec, init_weights(spec, seed=2), plan=plan, fuse=None,
    )
    assert net.report is not None and net.report.ok
    ref_net = RefEngine(hw=ref_analysis.HardwareModel(**_BIG)).compile(
        ref_spec, ref_init_weights(ref_spec, seed=2), plan=ref_plan, fuse=None,
    )
    x = (np.random.default_rng(4).standard_normal((2, 16, 16, 4)) * 0.1).astype(np.float32)
    assert _rel(net(x), ref_net(jnp.asarray(x))) < TOL
