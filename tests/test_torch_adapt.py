"""The port's adaptive replanning loop (`repro_torch.convserve.adapt`)
against the reference's, on the CPU, under one `SimClock` each.

Both packages run the reference's own scenarios (`tests/test_adapt.py`)
on the same testbed: tiny_testnet(4) on inline replicas, the tests'
large hardware model, the same fake stage-timing probe (each stage
"measures" at its roofline prediction times a per-kind factor) and the
same injected shadow timer.  They must give the same audit event
sequence (events and reasons), the same `adapt.*` counters, the same
candidate and final plans (algorithms and fusion groups), the same
shadow mode and verdict, the same invalidated-key counts, cost stores
whose JSON is equal up to the backend prefix (``torch-cpu`` for the
port), and served outputs within rel 1e-4 of each other (both fp32,
different summation orders) and within rel 1e-3 of the direct oracle.
Plus the satellite surfaces: the measured-cost store, the shadow
verifier, the wisdom stamps, the temporal conv1d registry path, the
telemetry schema, the stale-telemetry guard, and `costs=None` leaving
every plan as it was.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import convserve as ref_cs
from repro.configs import convnets as ref_convnets
from repro.convserve import planner as ref_planner
from repro.convserve import runtime as ref_rt
from repro.convserve.adapt import costs as ref_costs
from repro.core import analysis as ref_analysis
from repro.core import transforms as ref_transforms
from repro.core import tune as ref_tune
from repro_torch import convserve as cs
from repro_torch.configs import convnets
from repro_torch.convserve import planner
from repro_torch.convserve import runtime as rt_mod
from repro_torch.convserve.adapt import costs
from repro_torch.convserve.runtime.telemetry import stage_rollup
from repro_torch.core import analysis, registry, transforms, tune

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
SPEC, REF_SPEC = convnets.tiny_testnet(4), ref_convnets.tiny_testnet(4)
SERVE_TOL = 1e-4  # port vs reference, both fp32
ORACLE_TOL = 1e-3  # vs the direct-conv oracle (the reference's own)


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    """Both packages plan from the model alone: an empty wisdom file."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


@dataclasses.dataclass
class Bed:
    """One package's testbed: its modules, runtime, engine and weights."""

    port: bool
    cs: object
    rt_mod: object
    planner: object
    spec: object
    rt: object
    engine: object
    ws: dict


def _bed(port: bool, *, n: int = 1) -> Bed:
    pkg, rtm, pl, spec = (
        (cs, rt_mod, planner, SPEC) if port else (ref_cs, ref_rt, ref_planner, REF_SPEC)
    )
    hw = (analysis if port else ref_analysis).HardwareModel(**_BIG)
    engine = pkg.Engine(hw=hw, device="cpu") if port else pkg.Engine(hw=hw)
    ws = pkg.init_weights(spec, seed=5)
    pool = rtm.ReplicaPool.build(engine, spec, ws, n=n, workers=0, input_hw=(16, 16))
    cfg = rtm.RuntimeConfig(max_batch=2, buckets=(16,), slo_s=1.0, service_est_s=1e-4)
    rt = rtm.ServeRuntime(pool, cfg, clock=rtm.SimClock())
    return Bed(port, pkg, rtm, pl, spec, rt, engine, ws)


def _beds(**kw):
    return _bed(False, **kw), _bed(True, **kw)


def _probe(bed, fused_factor=10.0, single_factor=1.0, direct_factor=1000.0):
    """The reference tests' fake stage-timing probe: each stage measures
    at its roofline prediction scaled by a per-kind factor."""

    def factor(stage):
        if stage.fused:
            return fused_factor
        if stage.units[0].plan.algo == "direct":
            return direct_factor
        return single_factor

    def probe(net, bucket, batch):
        preds = bed.planner.predict_stage_times(net.program, bed.engine.hw)
        return [(label, pred * factor(stage))
                for stage, (label, pred) in zip(net.program.stages, preds)]

    return probe


def _controller(bed, shadow_timer=None, probe_kw=None, **cfg_kw):
    kw = dict(divergence_ratio=2.0, shadow_fraction=1.0, shadow_min_waves=2, cooldown_s=0.5)
    kw.update(cfg_kw)
    return bed.cs.AdaptController(
        bed.rt, bed.engine, bed.spec, bed.ws, bed.cs.AdaptConfig(**kw),
        probe=_probe(bed, **(probe_kw or {})), shadow_timer=shadow_timer,
    )


def _audit(ac):
    return [(a["event"], a["reason"]) for a in ac.audit]


def _adapt_counters(rt):
    return {k: v for k, v in rt.stats()["counters"].items() if k.startswith("adapt.")}


def _plan_key(plan):
    return plan.algos(), [dataclasses.astuple(g) for g in plan.groups]


def _store_doc(store, prefix):
    doc = store.to_json()
    assert all(k.startswith(prefix + ":") for k in doc)
    return {k[len(prefix) + 1:]: v for k, v in doc.items()}


def _images(n, side=16, seed=0):
    rng = np.random.default_rng(seed)
    return {i: (rng.standard_normal((side, side, 4)) * 0.1).astype(np.float32)
            for i in range(n)}


def _serve(bed, imgs):
    for i, im in imgs.items():
        assert bed.rt.submit(im, rid=i) is None
        bed.rt.poll()
    bed.rt.drain()


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _assert_served_alike(ref, port, imgs):
    missing = [i for i in imgs if i not in port.rt.results or i not in ref.rt.results]
    assert not missing, f"dropped requests: {missing}"
    for i, im in imgs.items():
        oracle = cs.run_direct(SPEC, port.ws, torch.from_numpy(im)[None])[0].numpy()
        assert _rel(port.rt.results[i], oracle) < ORACLE_TOL
        assert _rel(port.rt.results[i], ref.rt.results[i]) < SERVE_TOL


def _opened(shadow_timer=None, **probe_kw):
    """Both packages measured, probed and checked: (ref, port, ref
    controller, port controller, the two trigger reasons)."""
    ref, port = _beds()
    acs = [_controller(b, shadow_timer, probe_kw) for b in (ref, port)]
    reasons = []
    for ac in acs:
        ac.measure()
        ac.probe_alternatives()
        reasons.append(ac.check())
    return ref, port, acs[0], acs[1], reasons


# ------------------------------------------- (a) divergence -> replan


def test_divergence_triggers_replan_and_opens_shadow():
    ref, port, ref_ac, ac, (ref_reason, reason) = _opened(fused_factor=10.0)
    live_plan = port.rt.pool.executors[0].plan
    assert live_plan.groups, "seed plan must be fused for this test"
    assert reason is not None and reason == ref_reason
    assert ac.replans_triggered == ref_ac.replans_triggered == 1
    assert ac.state == ref_ac.state == "shadow"
    assert ac.candidate_plan.groups == () and ac.candidate_plan.algos() == live_plan.algos()
    assert _plan_key(ac.candidate_plan) == _plan_key(ref_ac.candidate_plan)
    assert ac.verifier.mode == ref_ac.verifier.mode == "bitwise"
    assert _audit(ac) == _audit(ref_ac)
    assert [e for e, _ in _audit(ac)] == ["replan", "shadow_open"]
    assert _adapt_counters(port.rt) == _adapt_counters(ref.rt) == {"adapt.replans_triggered": 1}
    assert [r["stage"] for r in ac.divergence()] == [r["stage"] for r in ref_ac.divergence()]
    # the cost stores agree up to the backend prefix
    assert _store_doc(ac.store, "torch-cpu") == _store_doc(ref_ac.store, jax.default_backend())


def test_matched_measurements_never_replan():
    ref, port, ref_ac, ac, reasons = _opened(fused_factor=1.0, single_factor=1.0)
    assert reasons == [None, None]
    for a in (ref_ac, ac):
        assert a.replans_triggered == 0 and a.state == "idle" and a.audit == []


# ------------------------- (b)+(c) shadow exactness, promote, rollback


def test_shadow_promotion_hot_swaps_with_zero_downtime():
    """Shadows run bit-exact beside live traffic, the injected timer says
    the candidate is faster, and promotion swaps the pool's program
    mid-traffic: every request served alike in both packages, no shadow
    wave in the client e2e histogram."""
    ref, port, ref_ac, ac, reasons = _opened(lambda res, cand_s: (0.010, 0.004))
    seed_plan = port.rt.pool.executors[0].plan
    assert None not in reasons
    imgs = _images(8)  # max_batch 2 -> 4 waves: 1 cold + 2 warm pairs + 1 post-swap
    for bed in (ref, port):
        _serve(bed, imgs)
    _assert_served_alike(ref, port, imgs)

    assert ac.promotions == ref_ac.promotions == 1 and ac.rollbacks == 0
    assert ac.state == "idle"
    final = port.rt.pool.executors[0].plan
    assert final.groups == () and final != seed_plan
    assert _plan_key(final) == _plan_key(ref.rt.pool.executors[0].plan)
    for key in ("mode", "waves", "requests", "mismatches", "cold_skipped", "paired_samples"):
        assert ac.last_verifier.stats()[key] == ref_ac.last_verifier.stats()[key], key
    assert ac.last_verifier.mode == "bitwise" and ac.last_verifier.mismatches == 0
    assert _audit(ac) == _audit(ref_ac) and ac.audit[-1]["event"] == "promote"
    assert _adapt_counters(port.rt) == _adapt_counters(ref.rt)
    assert port.rt.pool.cache.stats()["invalidations"] == ref.rt.pool.cache.stats()["invalidations"]
    snap = port.rt.stats()
    assert snap["latency"]["e2e"]["count"] == len(imgs)
    assert snap["latency"]["adapt.shadow_compute"]["count"] >= 2


def test_shadow_rollback_restores_live_program():
    ref, port, ref_ac, ac, reasons = _opened(lambda res, cand_s: (0.004, 0.010))
    seed_plan = port.rt.pool.executors[0].plan
    assert None not in reasons
    imgs = _images(8)
    for bed in (ref, port):
        _serve(bed, imgs)
    _assert_served_alike(ref, port, imgs)
    assert ac.rollbacks == ref_ac.rollbacks == 1 and ac.promotions == 0
    assert ac.state == "idle" and port.rt.pool.executors[0].plan == seed_plan
    roll = [a for a in ac.audit if a["event"] == "rollback"]
    assert roll and roll[0]["reason"] == "shadow_slower"
    assert _audit(ac) == _audit(ref_ac)
    assert _adapt_counters(port.rt) == _adapt_counters(ref.rt)
    # cooldown: the store still says "diverged" but check() waits
    assert ac.check() is None and ref_ac.check() is None
    assert ac.replans_triggered == 1


def test_hot_swap_invalidates_stale_cache_keys():
    """Swapping to a program that consumes no pre-transformed kernels
    drops the outgoing program's cache entries: as many in both."""
    dropped = {}
    for bed in _beds():
        pool = bed.rt.pool
        live = pool.executors[0]
        x = np.zeros((1, 16, 16, 4), np.float32)
        live(x)  # populate the shared cache
        keys = live.cache_keys()
        assert keys and len(keys) == len(set(keys))
        before = pool.cache.stats()["entries"]
        cand = bed.engine.compile(bed.spec, bed.ws, input_hw=(16, 16), allowed=("direct",),
                                  fuse=False)
        assert cand.cache_keys() == []
        old = bed.cs.hot_swap(pool, [cand], timeout_s=1.0)
        assert pool.executors[0] is cand and old[0] is live
        assert pool.cache.stats()["invalidations"] >= 1
        dropped[bed.port] = (len(keys), before - pool.cache.stats()["entries"])
    assert dropped[True] == dropped[False]
    assert dropped[True][1] == dropped[True][0]


def test_invalidate_keys_drops_only_what_it_names():
    cache = cs.KernelCache()
    engine = cs.Engine(hw=analysis.HardwareModel(**_BIG), cache=cache, device="cpu")
    net = engine.compile(SPEC, cs.init_weights(SPEC, seed=5), input_hw=(16, 16))
    net(np.zeros((1, 16, 16, 4), np.float32))
    keys = net.cache_keys()
    assert sorted(map(str, cache.keys())) == sorted(map(str, keys))
    assert cache.invalidate_keys([keys[0], ("no", "such", "key")]) == 1
    assert cache.invalidate_keys([]) == 0
    assert cache.stats()["invalidations"] == 1  # only a call that dropped counts
    assert len(cache.keys()) == len(keys) - 1


# ------------------------------------------- measured-cost store unit


@pytest.mark.parametrize("store_mod", ("port", "ref"))
def test_cost_store_ewma_cold_exclusion_and_staleness(store_mod):
    store = (costs if store_mod == "port" else ref_costs).MeasuredCostStore(ewma=0.5)
    store.observe("k", 1.0, predicted_s=0.5, now=0.0)
    store.observe("k", 2.0, now=10.0)
    e = store.entry("k")
    assert e.measured_s == pytest.approx(1.5) and e.n == 2
    assert e.predicted_s == 0.5 and e.ratio == pytest.approx(3.0)
    assert e.gen == 2 and e.ts == 10.0
    store.observe("k", 100.0, cold=True)
    assert store.entry("k").measured_s == pytest.approx(1.5)
    assert store.cold_skipped == 1
    assert store.lookup("k", max_age_s=5.0, now=20.0) is None
    assert store.lookup("k", max_age_s=15.0, now=20.0) == pytest.approx(1.5)
    assert store.entry("k", min_gen=3) is None
    assert store.entry("k", min_gen=2) is not None


def test_cost_store_ratio_scale_is_median():
    stores = (costs.MeasuredCostStore(), ref_costs.MeasuredCostStore())
    for store in stores:
        store.observe("a", 1.0, predicted_s=1.0, now=0.0)
        store.observe("b", 2.0, predicted_s=2.0, now=0.0)
        store.observe("c", 10.0, predicted_s=1.0, now=0.0)
        assert store.ratio_scale() == pytest.approx(1.0) and len(store) == 3
    assert stores[0].to_json() == stores[1].to_json()


def test_cost_store_roundtrips_through_json_and_reads_the_reference_file(tmp_path):
    store = costs.MeasuredCostStore(device="cpu")
    store.observe("x", 3.0, predicted_s=1.5, now=7.0)
    store.save(tmp_path / "costs.json")
    back = costs.MeasuredCostStore.load(tmp_path / "costs.json")
    e = back.entry("x")
    assert e.measured_s == 3.0 and e.predicted_s == 1.5 and e.ts == 7.0
    assert back.generation == store.generation
    ref_store = ref_costs.MeasuredCostStore()
    ref_store.observe("x", 3.0, predicted_s=1.5, now=7.0)
    ref_store.save(tmp_path / "ref.json")
    assert (tmp_path / "ref.json").read_text() == (tmp_path / "costs.json").read_text()


def test_cost_keys_match_the_reference_up_to_the_backend():
    spec = registry.ConvSpec(h=48, w=48, c_in=4, c_out=8, k=3, pad=1)
    from repro.core import registry as ref_registry

    ref_spec = ref_registry.ConvSpec(h=48, w=48, c_in=4, c_out=8, k=3, pad=1)
    assert costs.layer_key("fft_fused", spec, "torch-cpu") == (
        "torch-cpu:" + ref_costs.layer_key("fft_fused", ref_spec, "cpu").split(":", 1)[1])
    plan = planner.plan_net(SPEC, 16, 16, hw=analysis.HardwareModel(**_BIG))
    ref_plan = ref_planner.plan_net(REF_SPEC, 16, 16, hw=ref_analysis.HardwareModel(**_BIG))
    members = [p for p in plan.layers if p.layer in plan.groups[0].layers]
    ref_members = [p for p in ref_plan.layers if p.layer in ref_plan.groups[0].layers]
    assert costs.group_key(members, "b").split(":", 1)[1] == (
        ref_costs.group_key(ref_members, "b").split(":", 1)[1])
    assert costs.MeasuredCostStore(device="cpu").backend == "torch-cpu"
    assert costs.MeasuredCostStore(device="cuda").backend == "torch-cuda"


# -------------------------------------------------- shadow verifier unit


def test_shadow_verifier_mismatch_is_immediately_disqualifying():
    v = cs.ShadowVerifier(mode="bitwise", min_waves=3)
    a = np.ones((2, 2), np.float32)
    assert v.record({0: a}, {0: a}, live_compute_s=1.0, cand_compute_s=1.0)
    assert not v.record({1: a}, {1: a + 1e-7}, live_compute_s=1.0, cand_compute_s=1.0)
    assert v.verdict() == "rollback" and v.mismatches == 1


def test_shadow_verifier_needs_min_waves_and_skips_cold_pairs():
    v = cs.ShadowVerifier(mode="rtol", rtol=1e-3, min_waves=2)
    a = np.ones((2, 2), np.float32)
    b = a * (1 + 1e-5)  # within tolerance
    v.record({0: a}, {0: b}, live_compute_s=0.010, cand_compute_s=0.004)
    assert v.verdict() is None
    v.record({1: a}, {1: b}, live_compute_s=0.010, cand_compute_s=0.004, cold=True)
    assert v.cold_skipped == 1 and v.verdict() is None
    v.record({2: a}, {2: b}, live_compute_s=0.010, cand_compute_s=0.004)
    assert v.verdict() == "promote" and v.cand_mean_s == pytest.approx(0.004)
    with pytest.raises(ValueError, match="exactness"):
        cs.ShadowVerifier(mode="sometimes")


# ---------------------------------------- wisdom entries (tune reads)


def test_wisdom_entries_legacy_and_stamped_read_like_the_reference(tmp_path):
    """`lookup_r` reads a legacy bare-int entry and a stamped {r, gen, ts}
    entry as the reference reads the same file under its own backend
    prefix, and an absent key as None.  (The reference's staleness reads
    -- `wisdom_generation`, `entry_info`, `lookup_r(max_age_s=, min_gen=)`
    -- have no caller there or in the port and are not ported; the cost
    store's staleness is held above.)"""
    wino, ref_wino = transforms.WinogradTransform(m=5, k=3), ref_transforms.WinogradTransform(m=5, k=3)
    doc = {}
    for key_fn, tr, dev in ((tune._key, wino, "cpu"), (ref_tune._key, ref_wino, None)):
        kw = {"device": dev} if dev else {}
        doc[key_fn(tr, 8, 8, 4, 4, **kw)] = 7
        doc[key_fn(tr, 16, 16, 4, 4, **kw)] = {"r": 9, "gen": 3, "ts": 100.0}
    path = tmp_path / "wisdom.json"
    path.write_text(json.dumps(doc))
    for mod, tr, kw in ((tune, wino, {"device": "cpu"}), (ref_tune, ref_wino, {})):
        look = dict(transform=tr, wisdom_path=path, **kw)
        assert mod.lookup_r(8, 8, 4, 4, **look) == 7
        assert mod.lookup_r(16, 16, 4, 4, **look) == 9
        assert mod.lookup_r(32, 32, 4, 4, **look) is None


# ------------------------------- temporal conv1d via the registry


def test_temporal_spec_plans_conv1d_fused_and_matches_reference():
    b, length, d, k = 2, 64, 8, 4
    spec = registry.ConvSpec(h=1, w=length, c_in=d, c_out=d, k=k, pad=k - 1, stride=1,
                             groups=d)
    assert spec.temporal and spec.out_hw == (1, length)
    for name in ("direct", "l3_fused", "l3_fused_pallas", "three_stage", "fft_fused"):
        assert not registry.get(name).supports(spec)
    ap = registry.plan_conv(spec, analysis.SKYLAKE_X)
    assert ap.algo == "conv1d_fused"
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, 1, length, d)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((1, k, 1, d)) * 0.1).astype(np.float32)
    y = registry.get(ap.algo).execute(torch.from_numpy(x), torch.from_numpy(w), None, ap)
    ref = jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding=((0, 0), (k - 1, 0)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=d,
    )
    assert tuple(y.shape) == (b, 1, length, d)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)


# ----------------------------------------- telemetry snapshot schema


def test_telemetry_snapshot_schema_matches_the_reference():
    snaps = []
    for mod in (rt_mod, ref_rt):
        t = mod.Telemetry()
        t.inc("waves")
        t.set_gauge("queue_depth", 3.0)
        for v in [1e-4, 5e-4, 2e-3, 8e-3, 3e-2, 1e-1, 1e-1, 4e-1]:
            t.observe("e2e", v)
        snaps.append(t.snapshot(scheduler={"depth": 0}, stages=None))
    snap, ref_snap = snaps
    assert set(snap) == set(ref_snap) == {"meta", "counters", "gauges", "latency", "scheduler"}
    assert snap["meta"] == ref_snap["meta"] and snap["meta"]["seq"] == 10
    assert snap["latency"] == ref_snap["latency"]
    lat = snap["latency"]["e2e"]
    assert lat["count"] == 8 and lat["p50_s"] <= lat["p95_s"] <= lat["p99_s"] <= lat["max_s"]
    json.dumps(snap)


def test_stage_rollup_schema_is_stable():
    rows = stage_rollup([("conv0", 1e-3), ("fuse[1+2]", 2e-3)])
    assert [set(r) for r in rows] == [{"label", "us"}] * 2
    assert rows[0] == {"label": "conv0", "us": pytest.approx(1000.0)}


def test_runtime_stats_document_includes_adapt_counters():
    ref, port, ref_ac, ac, reasons = _opened(lambda res, cand_s: (0.010, 0.004))
    assert None not in reasons
    imgs = _images(8)
    for bed in (ref, port):
        _serve(bed, imgs)
    c = port.rt.stats()["counters"]
    assert c["adapt.replans_triggered"] == 1 and c["adapt.shadows_run"] >= 2
    assert c["adapt.promotions"] == 1 and "wave_observer_errors" not in c
    assert _adapt_counters(port.rt) == _adapt_counters(ref.rt)
    doc, ref_doc = ac.stats(), ref_ac.stats()
    assert set(doc) == set(ref_doc)
    for key in ("state", "replans_triggered", "shadows_run", "promotions", "rollbacks",
                "stale_checks", "store_entries"):
        assert doc[key] == ref_doc[key], key
    json.dumps(doc, default=str)


def test_adapt_stale_guard_counts_audits_and_suppresses():
    results = []
    for bed in _beds():
        ac = bed.cs.AdaptController(bed.rt, bed.engine, bed.spec, bed.ws,
                                    bed.cs.AdaptConfig(require_fresh_telemetry=True))
        bed.rt.telemetry.inc("traffic")
        guard = [ac._stale_guard(), ac._stale_guard()]
        ev = ac.audit[-1]
        c = bed.rt.telemetry.snapshot()["counters"]
        guard.append(ac._stale_guard())  # the counter inc bumped the stamp
        results.append((guard, ac.stale_checks, ev["event"], ev["blocked"],
                        c["adapt.stale_snapshot"]))
        bed.rt.pool.shutdown()
    assert results[0] == results[1] == ([False, True, False], 1, "stale_telemetry", True, 1)


# ------------------------------------------- costs=None leaves plans alone


@pytest.mark.parametrize("name", ("vgg_mixed_channel", "tiny_testnet", "resnet_downsample",
                                  "resnext_grouped", "fft_fewchannel"))
def test_plans_without_costs_are_unchanged(name):
    """`costs=None` and an empty store both give today's plan (measured
    costs only ever narrow the model), equal to the reference's."""
    spec = getattr(convnets, name)()
    for hw in (analysis.H100_SXM, analysis.SKYLAKE_X):
        base = planner.plan_net(spec, 64, 64, hw=hw)
        assert planner.plan_net(spec, 64, 64, hw=hw, costs=None) == base
        assert planner.plan_net(spec, 64, 64, hw=hw,
                                costs=costs.MeasuredCostStore(device="cpu")) == base
        ref_hw = ref_analysis.HardwareModel(**dataclasses.asdict(hw))
        ref_base = ref_planner.plan_net(getattr(ref_convnets, name)(), 64, 64, hw=ref_hw)
        assert _plan_key(base) == _plan_key(ref_base)
