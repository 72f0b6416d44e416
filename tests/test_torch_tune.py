"""The port's measuring tune and roofline calibration (`repro_torch.core.tune`,
`analysis.calibrated_hw`) against the reference's, on the CPU.

After `tests/test_fused_tile.py`'s wisdom and calibration tests: entries
measured by the port have the reference's stamped shape ({r, blocks,
gen, ts}) under the same key but for the backend prefix; block tuning
merges with a prior R and the reverse; `tune_r=True` plans measure,
store and consume an entry (the default plans nothing differently);
calibration measures once per backend and caches, and `calibrated_hw`
rescales the roofs while preserving CMR_fast, so the plan does not move.
"""

import json

import pytest

from repro.core import analysis as ref_analysis
from repro.core import transforms as ref_transforms
from repro.core import tune as ref_tune
from repro_torch import convserve as cs
from repro_torch.configs.convnets import tiny_testnet, vgg_mixed_channel
from repro_torch.core import analysis, registry, transforms, tune
from repro_torch.kernels.fused_tile import BlockConfig

BIG_HW = analysis.HardwareModel(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
GEOM = (12, 12, 2, 3)  # h, w, c_in, c_out: a few ms per candidate on the CPU


@pytest.fixture(autouse=True)
def _isolated_wisdom(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "default-wisdom.json"))
    tune._WISDOM_CACHE.clear()
    ref_tune._WISDOM_CACHE.clear()


def _fresh(path):
    """Simulate a process restart: drop the mtime-validated read cache."""
    tune._WISDOM_CACHE.clear()
    return path


# ------------------------------------------------------------- R wisdom


def test_tuned_r_measures_once_and_stores_the_reference_entry_shape(tmp_path):
    path = tmp_path / "wisdom.json"
    tr = transforms.WinogradTransform(m=3, k=3)
    assert tune.lookup_r(*GEOM, transform=tr, wisdom_path=path) is None
    r = tune.tuned_r(*GEOM, transform=tr, wisdom_path=path, device="cpu")
    assert r in tune.feasible_candidates(GEOM[2], GEOM[3], transform=tr)
    raw = json.loads(path.read_text())
    (key,) = raw
    assert key == tune._key(tr, *GEOM)
    assert key.startswith("torch-cpu:")
    entry = raw[key]
    assert entry["r"] == r and entry["gen"] == 1 and entry["ts"] > 0
    # the reference's key for the same transform + geometry, but for the
    # backend prefix, and its entry's fields
    ref_path = tmp_path / "ref-wisdom.json"
    ref_tr = ref_transforms.WinogradTransform(m=3, k=3)
    ref_tune.tuned_r(*GEOM, transform=ref_tr, wisdom_path=ref_path)
    (ref_key, ref_entry), = json.loads(ref_path.read_text()).items()
    assert key.split(":", 1)[1] == ref_key.split(":", 1)[1]
    assert set(entry) == set(ref_entry) == {"r", "gen", "ts"}
    # a second call reads the entry back: no measurement, same answer
    ts = entry["ts"]
    assert tune.tuned_r(*GEOM, transform=tr, wisdom_path=_fresh(path), device="cpu") == r
    assert json.loads(path.read_text())[key]["ts"] == ts
    assert tune.lookup_r(*GEOM, transform=tr, wisdom_path=path) == r


def test_tuned_blocks_preserves_prior_r(tmp_path):
    path = tmp_path / "wisdom.json"
    tr = transforms.WinogradTransform(m=3, k=3)
    tune.tuned_r(*GEOM, transform=tr, wisdom_path=path, device="cpu")
    r_before = tune.lookup_r(*GEOM, transform=tr, wisdom_path=path)
    assert r_before is not None
    tuned = tune.tuned_blocks(*GEOM, transform=tr, wisdom_path=path, device="cpu")
    assert isinstance(tuned, BlockConfig)
    assert tune.lookup_r(*GEOM, transform=tr, wisdom_path=_fresh(path)) == r_before
    assert tune.lookup_blocks(*GEOM, transform=tr, wisdom_path=path) == tuned
    entry = json.loads(path.read_text())[tune._key(tr, *GEOM)]
    assert set(entry) == {"r", "blocks", "gen", "ts"} and entry["gen"] == 2
    assert entry["blocks"] == tuned.to_wisdom()

    # and the reverse: an R pass on a blocks-only key merges too
    tr2 = transforms.WinogradTransform(m=4, k=3)
    tuned2 = tune.tuned_blocks(*GEOM, transform=tr2, wisdom_path=path, device="cpu")
    tune.tuned_r(*GEOM, transform=tr2, wisdom_path=path, device="cpu")
    assert tune.lookup_blocks(*GEOM, transform=tr2, wisdom_path=_fresh(path)) == tuned2


def test_block_candidates_match_reference():
    for c_in, c_out in ((2, 3), (64, 64), (256, 256)):
        got = tune.block_candidates(c_in, c_out, transforms.WinogradTransform(m=5, k=3),
                                    hw=analysis.SKYLAKE_X)
        want = ref_tune.block_candidates(c_in, c_out, ref_transforms.WinogradTransform(m=5, k=3),
                                         hw=ref_analysis.SKYLAKE_X)
        assert [b.to_wisdom() for b in got] == [b.to_wisdom() for b in want]


def test_measure_blocks_skips_a_shape_the_engine_refuses(monkeypatch):
    """A candidate that raises `UnsupportedSpec` is skipped, as in the
    reference; the fastest of the others wins."""
    from repro_torch.kernels import fused_tile as ft

    real = ft.conv2d_fused_tile

    def refuse_r8(*a, blocks=None, **kw):
        if blocks.r == 8:
            raise ft.UnsupportedSpec("refused")
        return real(*a, blocks=blocks, **kw)

    monkeypatch.setattr(ft, "conv2d_fused_tile", refuse_r8)
    cands = [BlockConfig(r=8), BlockConfig(r=4, tasks_per_program=2)]
    got = tune.measure_blocks(*GEOM, m=3, candidates=cands, device="cpu", reps=1)
    assert got == cands[1]


# ------------------------------------------------------ tune_r planning


def test_tune_r_plans_measure_store_and_consume_an_entry(tmp_path):
    """`plan_conv(tune_r=True)` measures R for the auto winner only and
    stores it; a later default plan reads the stored R (tuned=True)."""
    path = tmp_path / "wisdom.json"
    spec = registry.ConvSpec(h=12, w=12, c_in=2, c_out=3, k=3, pad=1)
    plain = registry.plan_conv(spec, BIG_HW, hints={"m": 3}, wisdom_path=path,
                               device="cpu")
    assert not path.exists() and not plain.tuned
    ap = registry.plan_conv(spec, BIG_HW, hints={"m": 3}, tune_r=True, wisdom_path=path,
                            device="cpu")
    assert ap.algo == plain.algo and ap.tuned
    raw = json.loads(path.read_text())
    assert len(raw) == 1  # the winner only
    (entry,) = raw.values()
    assert ap.params["r_tiles"] == entry["r"]
    again = registry.plan_conv(spec, BIG_HW, hints={"m": 3}, wisdom_path=_fresh(path),
                               device="cpu")
    assert again.tuned and again.params["r_tiles"] == entry["r"]


def test_a_cpu_engine_tunes_and_stores_for_the_cpu_beside_a_card(tmp_path, monkeypatch):
    """The engine's device, not what is installed, decides where R is
    measured and under which key it is stored: with a card present, a CPU
    engine's `tune_r=True` plan writes torch-cpu keys only, and reads
    them back."""
    monkeypatch.setattr(tune.torch.cuda, "is_available", lambda: True)
    spec = tiny_testnet(4)
    ws = cs.init_weights(spec, seed=0)
    engine = cs.Engine(hw=BIG_HW, device="cpu")
    path = tmp_path / "wisdom.json"
    on = engine.compile(spec, ws, input_hw=(16, 16), tune_r=True, wisdom_path=path)
    keys = list(json.loads(path.read_text()))
    assert keys and all(k.startswith("torch-cpu:") for k in keys)
    again = engine.compile(spec, ws, input_hw=(16, 16), wisdom_path=_fresh(path))
    assert again.plan == on.plan


_MEASURING = {
    "measure_r": lambda path: tune.measure_r(*GEOM, m=3),
    "tuned_r": lambda path: tune.tuned_r(*GEOM, m=3, wisdom_path=path),
    "measure_blocks": lambda path: tune.measure_blocks(*GEOM, m=3),
    "tuned_blocks": lambda path: tune.tuned_blocks(*GEOM, m=3, wisdom_path=path),
    "run_calibration": lambda path: tune.run_calibration(),
    "measure_calibration": lambda path: tune.measure_calibration(path),
    "calibrated_hw": lambda path: analysis.calibrated_hw(analysis.H100_SXM, path),
}


@pytest.mark.parametrize("name", sorted(_MEASURING))
def test_measuring_without_a_card_or_a_device_raises(tmp_path, monkeypatch, name):
    """No measuring entry point quietly falls back to the CPU: without a
    card and without a named device it raises, and writes nothing."""
    monkeypatch.setattr(tune.torch.cuda, "is_available", lambda: False)
    path = tmp_path / "wisdom.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _MEASURING[name](path)
    assert not path.exists()


def test_default_plans_are_unchanged_by_the_knob(tmp_path):
    """`tune_r` defaults to False: every plan of the port is what it was,
    and the knob threads through `Engine.compile` -> `plan_net`."""
    spec = tiny_testnet(4)
    ws = cs.init_weights(spec, seed=0)
    engine = cs.Engine(hw=BIG_HW, device="cpu")
    base = engine.compile(spec, ws, input_hw=(16, 16))
    off = engine.compile(spec, ws, input_hw=(16, 16), tune_r=False)
    assert off.plan == base.plan
    path = tmp_path / "wisdom.json"
    on = engine.compile(spec, ws, input_hw=(16, 16), tune_r=True, wisdom_path=path)
    assert on.plan.algos() == base.plan.algos()
    transformed = [p for p in on.plan.layers if p.algo != "direct"]
    assert transformed  # the knob has R to measure on this net
    stored = json.loads(path.read_text())
    assert len(stored) == len(transformed)  # one entry per measured layer
    assert sorted(p.params["r_tiles"] for p in transformed) == sorted(
        e["r"] for e in stored.values())


# ------------------------------------------------------------- calibration


def test_calibration_measures_once_and_caches(tmp_path):
    path = tmp_path / "wisdom.json"
    assert tune.lookup_calibration(path, "cpu") is None
    first = tune.measure_calibration(path, device="cpu")
    assert first["peak_flops"] > 0 and first["dram_bw"] > 0
    assert (first["gemm_n"], first["stream_mb"]) == (768, 32)  # the reference's sizes
    raw = json.loads(path.read_text())
    assert list(raw) == ["calib:torch-cpu"] and raw["calib:torch-cpu"]["gen"] == 1
    again = tune.measure_calibration(_fresh(path), device="cpu")
    assert again["ts"] == first["ts"]  # served from the stamped cache
    assert tune.lookup_calibration(path, "cpu")["peak_flops"] == first["peak_flops"]
    fresh = tune.measure_calibration(path, device="cpu", refresh=True)
    assert fresh["gen"] == 2


def test_card_calibration_is_sized_past_launch_overhead_and_l2():
    """On the card the GEMM is n = 8192 and the stream 512 MB each way,
    10x the H100's 50 MB L2; the CPU keeps the reference's sizes."""
    assert tune._CALIB_GEMM_N == {"cpu": ref_tune._CALIB_GEMM_N, "cuda": 8192}
    assert tune._CALIB_STREAM_MB["cpu"] == ref_tune._CALIB_STREAM_MB
    assert tune._CALIB_STREAM_MB["cuda"] * 2**20 >= 5 * analysis.H100_SXM.fast_shared_bytes


@pytest.mark.parametrize("base", ["SKYLAKE_X", "H100_SXM"])
def test_calibrated_hw_rescales_roofs_and_preserves_cmr_fast(tmp_path, base):
    path = tmp_path / "wisdom.json"
    entry = tune.measure_calibration(path, device="cpu")
    b = getattr(analysis, base)
    hw = analysis.calibrated_hw(b, wisdom_path=path, device="cpu")
    assert hw.name == b.name + ":calibrated"
    assert (hw.peak_flops, hw.dram_bw) == (entry["peak_flops"], entry["dram_bw"])
    assert hw.peak_flops / hw.fast_shared_bw == pytest.approx(b.cmr_fast, rel=1e-12)
    assert (hw.fast_shared_bytes, hw.private_bytes) == (b.fast_shared_bytes, b.private_bytes)
    assert analysis.min_r(hw) == analysis.min_r(b)
    # the reference's rescaling of the same numbers
    ref_b = getattr(ref_analysis, base) if hasattr(ref_analysis, base) else None
    if ref_b is not None:
        ref_path = tmp_path / "ref.json"
        ref_path.write_text(json.dumps({ref_tune._calib_key(): entry}))
        ref_hw = ref_analysis.calibrated_hw(ref_b, wisdom_path=ref_path, measure=False)
        assert (ref_hw.peak_flops, ref_hw.dram_bw, ref_hw.fast_shared_bw) == (
            hw.peak_flops, hw.dram_bw, hw.fast_shared_bw)


def test_calibrated_hw_without_measuring_returns_the_base(tmp_path):
    path = tmp_path / "none.json"
    assert analysis.calibrated_hw(analysis.H100_SXM, wisdom_path=path, measure=False,
                                  device="cpu") is analysis.H100_SXM
    assert not path.exists()


def test_calibrated_plan_equals_the_uncalibrated_plan(tmp_path):
    """CMR_fast preserved: min R, the R bounds and the fusion groups do
    not move, so vgg_mixed_channel plans the same algorithms per layer."""
    path = tmp_path / "wisdom.json"
    hw = analysis.calibrated_hw(analysis.H100_SXM, wisdom_path=path, device="cpu")
    spec = vgg_mixed_channel(3)
    a = cs.plan_net(spec, 64, 64, hw=analysis.H100_SXM)
    b = cs.plan_net(spec, 64, 64, hw=hw)
    assert a.algos() == b.algos()
    assert [p.params for p in a.layers] == [p.params for p in b.layers]
    assert a.groups == b.groups
