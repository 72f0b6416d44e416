"""The port's elastic fleet (`repro_torch.convserve.fleet`) against the
reference's, on the CPU.

Each test builds the same fleet in both packages -- the test net of
`tests/test_fleet.py` (tiny_testnet(4), weights from seed 5, the large
hardware model), one `SimClock` each, the same trace, service model and
fault plan -- drives both through the same steps, and checks what the
reference test checks on the port.  Simulated time, wave formation,
fault instants and the autoscaler are deterministic, so the audit
events, the fired faults, the losses by rid, the pool's counters, the
telemetry counters and histograms and the stats' key schema must be
EQUAL to the reference's.  Outputs agree within SERVE_TOL of the
reference's and ORACLE_TOL of the direct oracle.  A sharded wave is
held within SHARD_TOL of the unsharded one, not bit for bit: a shard is
a smaller batch, which may take another kernel geometry or library
algorithm (ROADMAP §3, the sharded-wave tolerance).
"""

import json
import math

import numpy as np
import pytest
import torch

from repro import convserve as ref_cs
from repro.configs.convnets import tiny_testnet as ref_tiny_testnet
from repro.convserve import fleet as ref_fleet
from repro.convserve import runtime as ref_rt
from repro.core import analysis as ref_analysis
from repro.runtime import fault as ref_fault
from repro_torch import convserve as cs
from repro_torch.configs.convnets import tiny_testnet
from repro_torch.convserve import cache as cache_mod
from repro_torch.convserve import fleet
from repro_torch.convserve import runtime as rt_mod
from repro_torch.core import analysis
from repro_torch.distributed.sharding import Mesh
from repro_torch.runtime import fault

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
SPEC, REF_SPEC = tiny_testnet(4), ref_tiny_testnet(4)
SERVE_TOL = 1e-4  # port vs reference, both fp32
ORACLE_TOL = 1e-3  # vs the direct-conv oracle (the reference's own)
SHARD_TOL = 1e-5  # sharded vs unsharded wave of one plan
SERVICE = dict(base_s=0.004, per_image_s=0.002)
CFG = dict(buckets=(16,), max_batch=4, queue_depth=256, slo_s=0.25,
           service_est_s=0.012)
IMG = np.zeros((16, 16, 4), np.float32)


class _Pkg:
    """One package's fleet surface under one set of names."""

    def __init__(self, side):
        self.side = side
        port = side == "port"
        self.cs = cs if port else ref_cs
        self.fleet = fleet if port else ref_fleet
        self.rt = rt_mod if port else ref_rt
        self.fault = fault if port else ref_fault
        self.analysis = analysis if port else ref_analysis
        self.spec = SPEC if port else REF_SPEC
        self.engine_kw = {"device": "cpu"} if port else {}

    def engine(self):
        return self.cs.Engine(hw=self.analysis.HardwareModel(**_BIG), **self.engine_kw)

    def weights(self):
        return self.cs.init_weights(self.spec, seed=5)


PKGS = {side: _Pkg(side) for side in ("reference", "port")}


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    """Both packages plan from the model alone: an empty wisdom file."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _fleet(side, n=2, *, shards=1, cfg=None, autoscaler=None, adapt=None,
           faults=(), **pool_kwargs):
    """Deterministic fleet in one package: SimClock + fixed service
    model (`tests/test_fleet.py::_fleet`); `faults` are ReplicaFault
    keyword dicts, built against this fleet's own clock."""
    m = PKGS[side]
    clock = m.rt.SimClock()
    plan = (m.fault.FaultPlan([m.fault.ReplicaFault(**f) for f in faults], clock=clock)
            if faults else None)
    pool = m.fleet.ElasticPool.build(
        m.engine(), m.spec, m.weights(), n=n, clock=clock, input_hw=(16, 16),
        shards=shards, service_model=m.fleet.FixedServiceModel(**SERVICE),
        fault_plan=plan, **pool_kwargs,
    )
    rt = m.fleet.FleetRuntime(
        pool, m.rt.RuntimeConfig(**(cfg or CFG)), clock=clock,
        autoscaler=m.fleet.AutoscalerConfig(**autoscaler) if autoscaler else None,
        adapt=adapt,
    )
    return rt, clock


def _both(scenario, *args, **kwargs):
    """Run `scenario(side, rt, clock)` on a fleet of each package built
    from the same arguments; returns {side: (rt, clock, scenario's value)}."""
    out = {}
    for side in PKGS:
        rt, clock = _fleet(side, *args, **kwargs)
        out[side] = (rt, clock, scenario(side, rt, clock))
    return out


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-12))


def _oracle(image: np.ndarray) -> np.ndarray:
    ws = cs.init_weights(SPEC, seed=5)
    return cs.run_direct(SPEC, ws, torch.from_numpy(image)[None])[0].numpy()


def _accounting(rt) -> dict:
    c = rt.stats()["counters"]
    served = c.get("images", 0)
    lost = c.get("lost_images", 0)
    assert served + lost == c.get("admitted", 0)
    return {"served": served, "lost": lost,
            "admitted": c.get("admitted", 0),
            "rejected": c.get("rejected", 0)}


def _keys(doc, depth=2):
    """The stats document's key schema, `depth` levels down."""
    if depth == 0 or not isinstance(doc, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in doc.items()}


def _same_story(runs, images=None):
    """The port's run tells the reference's story: equal audit events,
    fired faults, losses by rid, pool counters, telemetry counters and
    histograms (all simulated time) and stats schema; the same served
    rids, within SERVE_TOL of the reference and ORACLE_TOL of direct."""
    ref, port = runs["reference"][0], runs["port"][0]
    doc, ref_doc = port.stats(), ref.stats()
    json.dumps(doc)
    assert _keys(doc) == _keys(ref_doc)
    assert doc["counters"] == ref_doc["counters"]
    assert doc["latency"] == ref_doc["latency"]
    assert doc["scheduler"] == ref_doc["scheduler"]
    assert doc["losses"] == ref_doc["losses"]
    assert port.losses == ref.losses
    pool, ref_pool = dict(doc["pool"]), dict(ref_doc["pool"])
    cache, ref_cache = pool.pop("cache"), ref_pool.pop("cache")
    assert pool == ref_pool  # counters, states, per-replica rows, faults fired
    # tiny_testnet's transforms have the same layouts in both packages
    assert cache == ref_cache
    if "autoscaler" in ref_doc:
        assert doc["autoscaler"] == ref_doc["autoscaler"]  # events included
    assert {r: rj.reason for r, rj in port.rejections.items()} == {
        r: rj.reason for r, rj in ref.rejections.items()}
    assert set(port.results) == set(ref.results)
    for rid, y in port.results.items():
        assert _rel(y, ref.results[rid]) < SERVE_TOL, rid
        if images is not None:
            assert _rel(y, _oracle(images[rid])) < ORACLE_TOL, rid
    return doc


def _trace(side, *args, **kwargs):
    return PKGS[side].rt.poisson_trace(*args, **kwargs)


class _AdaptStub:
    """Records pause/resume bracketing (the replanner's fleet surface)."""

    def __init__(self):
        self.events = []

    def pause(self, reason="x"):
        self.events.append(("pause", reason))

    def resume(self):
        self.events.append(("resume", None))


# ------------------------------------------------------------ traces


def test_diurnal_trace_is_seeded_and_shaped():
    kw = dict(seed=3, period_s=10.0, sizes=(12, 16))
    a = rt_mod.diurnal_trace(50.0, 500, **kw)
    assert [tuple(vars(r).values()) for r in a] == [
        tuple(vars(r).values()) for r in ref_rt.diurnal_trace(50.0, 500, **kw)]
    assert [r.t for r in a] == sorted(r.t for r in a)
    trough = sum(1 for r in a if r.t % 10.0 < 1.5)
    peak = sum(1 for r in a if 4.0 <= r.t % 10.0 < 6.0)
    assert peak > 2 * trough > 0
    with pytest.raises(ValueError):
        rt_mod.diurnal_rate(50.0, depth=1.5)


@pytest.mark.parametrize("t", [0.0, 2.5, 5.0, 7.5, 10.0])
def test_diurnal_rate_profile(t):
    rate = rt_mod.diurnal_rate(100.0, depth=0.5, period_s=10.0)
    assert rate(t) == ref_rt.diurnal_rate(100.0, depth=0.5, period_s=10.0)(t)
    assert rate(0.0) == pytest.approx(50.0) and rate(5.0) == pytest.approx(150.0)


def test_merge_traces_dense_rids_preserve_payload():
    def merged(m):
        a = m.poisson_trace(100.0, 20, seed=1, sizes=(12,), priorities=(0,))
        b = m.poisson_trace(80.0, 15, seed=2, sizes=(16,), priorities=(2,))
        return m.merge_traces(a, b)

    m, ref_m = merged(rt_mod), merged(ref_rt)
    assert [tuple(vars(r).values()) for r in m] == [tuple(vars(r).values()) for r in ref_m]
    assert [r.rid for r in m] == list(range(35))
    assert sum(1 for r in m if r.priority == 2) == 15
    assert sum(1 for r in m if r.h == 12) == 20
    imgs, ref_imgs = rt_mod.make_images(m, 4, seed=1), ref_rt.make_images(ref_m, 4, seed=1)
    assert imgs.keys() == ref_imgs.keys() == set(range(35))
    assert all(np.array_equal(imgs[k], ref_imgs[k]) for k in imgs)


# ----------------------------------------------------------- sharding


@pytest.mark.parametrize("n,shards", [(10, 4), (2, 4), (8, 1), (0, 4), (17, 5),
                                      (4, 0), (7, 7), (3, 8)])
def test_shard_bounds_partition(n, shards):
    bounds = fleet.shard_bounds(n, shards)
    assert bounds == ref_fleet.shard_bounds(n, shards)
    if bounds:
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))
        assert all(hi > lo for lo, hi in bounds)


def _ragged_wave():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 16, 16, 4)) * 0.1).astype(np.float32)
    ext = np.array([[16, 16], [12, 12], [16, 14], [8, 16], [0, 0]], np.int32)
    return x, ext


def test_sharded_executor_within_tolerance_on_ragged_wave():
    """The port's counterpart of `test_sharded_executor_bit_exact_on_
    ragged_wave`: 1e-5 against the unsharded wave, not bitwise."""
    ws = cs.init_weights(SPEC, seed=5)
    engine = PKGS["port"].engine()
    net = engine.compile(SPEC, ws, input_hw=(16, 16))
    x, ext = _ragged_wave()
    y1 = net(x, ext).numpy()
    sharded = fleet.ShardedWaveExecutor(
        engine.compile(SPEC, ws, plan=net.plan, input_hw=(16, 16)), shards=3,
    )
    y = sharded(x, ext)
    assert isinstance(y, torch.Tensor) and y.shape == y1.shape
    assert _rel(y.numpy(), y1) <= SHARD_TOL
    ref_net = PKGS["reference"].engine().compile(
        REF_SPEC, ref_cs.init_weights(REF_SPEC, seed=5), input_hw=(16, 16))
    assert _rel(y.numpy(), np.asarray(ref_net(x, ext))) < SERVE_TOL
    # the extent-0 row is fully masked in every shard
    assert not y[4].any()
    # passthroughs keep the CompiledNet duck type intact
    assert sharded.spec is net.spec and sharded.cache is net.cache
    assert sharded.executor is sharded.net.executor
    assert rt_mod.replicas.replica_device(sharded) == torch.device("cpu")


@pytest.mark.parametrize("threshold", [1, 40_000, 60_000, 1 << 40])
def test_weight_placement_is_a_threshold_decision(threshold):
    """Decisions and resident bytes equal the reference's at every
    threshold (tiny_testnet's transforms have the same layout in both);
    unprepared layers fall back to the same closed-form estimate."""
    def placement(side, warm):
        m = PKGS[side]
        net = m.engine().compile(m.spec, m.weights(), input_hw=(16, 16))
        if warm:
            net(np.zeros((1, 16, 16, 4), np.float32))  # make transforms resident
        return m.fleet.plan_weight_placement(net, threshold_bytes=threshold)

    for warm in (True, False):
        got, want = placement("port", warm), placement("reference", warm)
        assert got == want, warm
    tiny = placement("port", True)
    consuming = [layer for layer, d in tiny.items() if d["bytes"] > 0]
    assert consuming, "tiny_testnet should have transformed layers"
    if threshold == 1:
        assert all(tiny[k]["placement"] == fleet.SHARD for k in consuming)
    if threshold == 1 << 40:
        assert all(d["placement"] == fleet.REPLICATE for d in tiny.values())


@pytest.mark.parametrize("warm", [False, True])
def test_weight_placement_on_vgg_matches_the_reference(warm):
    """vgg_mixed_channel at 64 px under the SkylakeX model (both packages
    plan `l3_fused` x5 and `three_stage`): the same decision per layer
    at the default 1 MiB threshold, from the closed-form estimate before
    the transforms are prepared and from the resident bytes after.  The
    port stores every transform in the reference's layout (t^2 x C x C'
    fp32), so no layer's bytes differ.  The reference's decision under a
    mesh (of its one device) is the same: it is each layer's alone, and
    the port's takes no mesh."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from repro.configs.convnets import vgg_mixed_channel as ref_vgg
    from repro_torch.configs.convnets import vgg_mixed_channel

    def placement(side):
        m = PKGS[side]
        spec = (vgg_mixed_channel if side == "port" else ref_vgg)(3)
        net = m.cs.Engine(hw=m.analysis.SKYLAKE_X, **m.engine_kw).compile(
            spec, m.cs.init_weights(spec, seed=0), input_hw=(64, 64))
        if warm:
            net(np.zeros((1, 64, 64, 3), np.float32))
        if side == "port":
            return list(net.plan.algos()), m.fleet.plan_weight_placement(net)
        mesh = JaxMesh(np.array(jax.devices()[:1]), ("data",))
        return (list(net.plan.algos()), m.fleet.plan_weight_placement(net),
                m.fleet.plan_weight_placement(net, mesh=mesh))

    (algos, got), (ref_algos, want, want_mesh) = placement("port"), placement("reference")
    assert algos == ref_algos
    assert got == want == want_mesh
    assert {d["placement"] for d in got.values()} == {fleet.SHARD, fleet.REPLICATE}
    why = "resident transform bytes" if warm else "estimated (not yet prepared)"
    assert all(d["why"] == why for d in got.values())


# -------------------------------------------- exactness vs the oracle


def test_fleet_matches_single_replica_oracle_with_ragged_waves():
    """Three sharded replicas against one unsharded: every request within
    SHARD_TOL (`test_fleet.py` asks bitwise; ROADMAP §3), ragged partial
    waves included; each fleet's story equal to the reference's."""
    trace = rt_mod.poisson_trace(45.0, 40, seed=7, sizes=(8, 12, 16), deadline_s=0.08)
    images = rt_mod.make_images(trace, 4, seed=1)
    cfg = dict(buckets=(16,), max_batch=4, queue_depth=128, slo_s=0.1,
               service_est_s=0.01)

    def serve(side, rt, clock):
        rt.warmup([2, 4])
        return rt.play(_trace(side, 45.0, 40, seed=7, sizes=(8, 12, 16), deadline_s=0.08),
                       images)

    fleet_runs = _both(serve, 3, shards=2, cfg=cfg)
    oracle_runs = _both(serve, 1, shards=1, cfg=cfg)
    doc = _same_story(fleet_runs, images)
    _same_story(oracle_runs, images)
    fleet_out, oracle_out = fleet_runs["port"][2], oracle_runs["port"][2]
    assert fleet_out.keys() == oracle_out.keys() == {a.rid for a in trace}
    for rid in oracle_out:
        assert _rel(fleet_out[rid], oracle_out[rid]) <= SHARD_TOL, rid
    assert doc["scheduler"]["partial_waves"] >= 1


# ------------------------------------------------- simulated elasticity


@pytest.mark.parametrize("n", [1, 2, 4])
def test_replicas_add_simulated_parallelism(n):
    """Makespans equal the reference's at every fleet size; T(4) holds
    the reference's floor against T(1)."""
    cfg = dict(buckets=(16,), max_batch=4, queue_depth=512, slo_s=None,
               service_est_s=0.012)

    def makespan(side, rt, clock):
        trace = _trace(side, 5000.0, 240, seed=3, sizes=(16,))
        rt.warmup()
        rt.play(trace, PKGS[side].rt.make_images(trace, 4, seed=1))
        assert _accounting(rt)["served"] == 240
        return clock.now()

    runs = _both(makespan, n, cfg=cfg)
    _same_story(runs)
    assert runs["port"][2] == runs["reference"][2]
    if n == 4:
        m1 = _both(makespan, 1, cfg=cfg)["port"][2]
        assert runs["port"][2] < m1 / 2.5


def test_autoscaler_grows_under_pressure_and_gates_admission():
    auto = dict(
        min_replicas=1, max_replicas=4, tick_interval_s=0.01, cooldown_s=0.05,
        queue_high=2.0, queue_low=0.1, slack_comfort_s=math.inf,
        admission_queue_per_replica=12.0,
    )

    def drill(side, rt, clock):
        adapt = rt.adapt
        rt.warmup()
        for i in range(40):
            rt.submit(IMG, rid=i, deadline_s=10.0)
        rt.run_until(0.2)
        counts = rt.pool.counts()
        assert counts.get("starting", 0) >= 1, counts
        assert rt.autoscaler.scaling(clock.now())
        assert ("pause", "scale_event:up") in adapt.events
        rejected = [r for r in (rt.submit(IMG, rid=i, deadline_s=10.0)
                                for i in range(40, 80)) if r is not None]
        assert rejected and all(r.reason == PKGS[side].rt.REJECT_SCALING for r in rejected)
        rt.run_until(1.0)
        assert rt.pool.ready_count() >= 2
        rt.drain()
        acct = _accounting(rt)
        assert acct["served"] == acct["admitted"] > 0
        assert acct["rejected"] == len(rejected)
        assert ("resume", None) in adapt.events
        return list(adapt.events)

    runs = {}
    for side in PKGS:
        rt, clock = _fleet(side, 1, autoscaler=auto, adapt=_AdaptStub(), startup_s=0.5)
        runs[side] = (rt, clock, drill(side, rt, clock))
    _same_story(runs)
    assert runs["port"][2] == runs["reference"][2]  # the pause/resume bracket


def test_autoscaler_scales_down_and_drains_before_retire():
    auto = dict(min_replicas=1, max_replicas=4, tick_interval_s=0.02, cooldown_s=0.05,
                queue_high=50.0, queue_low=0.5, slack_comfort_s=-math.inf)

    def drill(side, rt, clock):
        rt.warmup()
        for i in range(12):
            rt.submit(IMG, rid=i, deadline_s=5.0)
        rt.run_until(2.0)
        rt.drain()
        counts = rt.pool.counts()
        assert counts.get("retired", 0) >= 1, counts
        assert counts.get("ready", 0) >= 1
        acct = _accounting(rt)
        assert acct["served"] == 12 and acct["lost"] == 0

    _same_story(_both(drill, 3, autoscaler=auto))


def test_pool_retire_waits_for_inflight_wave():
    def drill(side, rt, clock):
        rt.warmup()
        for i in range(8):
            rt.submit(IMG, rid=i, deadline_s=5.0)
        rt.poll()
        assert rt.pool.ready_count() == 2 and not rt.pool.has_capacity()
        gone = rt.pool.retire(1)
        assert gone and rt.pool.counts().get("draining") == 1
        rt.drain()
        assert rt.pool.counts().get("retired") == 1
        assert _accounting(rt)["served"] == 8
        return gone

    runs = _both(drill, 2)
    _same_story(runs)
    assert runs["port"][2] == runs["reference"][2]


# ------------------------------------------------------------- faults


def test_crash_orphans_wave_into_retry_without_double_count():
    def drill(side, rt, clock):
        rt.warmup()
        trace = _trace(side, 400.0, 48, seed=3, sizes=(16,), deadline_s=1.0)
        rt.play(trace, PKGS[side].rt.make_images(trace, 4, seed=1))
        p = rt.stats()["pool"]
        assert p["failures"] == 1 and p["orphaned"] >= 1 and p["retries"] >= 1
        acct = _accounting(rt)
        assert acct["served"] == 48 and acct["lost"] == 0
        doc = rt.stats()
        assert doc["counters"]["waves"] == doc["scheduler"]["waves"]
        assert doc["counters"]["images"] == 48
        assert len(rt.results) == 48

    trace = rt_mod.poisson_trace(400.0, 48, seed=3, sizes=(16,), deadline_s=1.0)
    _same_story(_both(drill, 2, faults=[dict(t=0.016, kind="crash", replica=0)]),
                rt_mod.make_images(trace, 4, seed=1))


def test_retries_exhausted_is_a_reason_coded_loss():
    faults = [dict(t=0.010, kind="crash", replica=0), dict(t=0.012, kind="crash", replica=1)]

    def drill(side, rt, clock):
        rt.warmup()
        for i in range(16):
            rt.submit(IMG, rid=i, deadline_s=1.0)
        rt.drain()
        acct = _accounting(rt)
        assert acct["lost"] >= 1
        assert set(rt.losses.values()) <= set(fleet.LOSS_REASONS)
        assert fleet.LOSS_RETRIES_EXHAUSTED in set(rt.losses.values())
        p = rt.stats()["pool"]
        assert p["states"].get("failed") == 2
        if fleet.LOSS_NO_HEALTHY_REPLICA in p["losses"]:
            assert p["losses"][fleet.LOSS_NO_HEALTHY_REPLICA] >= 1
        with rt._lock:
            assert set(rt.results) | set(rt.losses) == set(range(16))

    _same_story(_both(drill, 2, faults=faults, max_retries=0))


def test_autoscaler_replaces_failed_replicas_ignoring_cooldown():
    auto = dict(min_replicas=2, max_replicas=4, tick_interval_s=0.02, cooldown_s=1e9,
                queue_high=1e9, queue_low=0.0)

    def drill(side, rt, clock):
        rt.warmup()
        rt.run_until(0.5)
        assert rt.stats()["autoscaler"]["replacements"] >= 1
        assert rt.pool.ready_count() >= 2

    _same_story(_both(drill, 2, faults=[dict(t=0.05, kind="crash", replica=0)],
                      autoscaler=auto, startup_s=0.05))


def test_cache_corruption_detected_and_repaired_by_probes():
    trace = rt_mod.poisson_trace(200.0, 12, seed=3, sizes=(16,))
    images = rt_mod.make_images(trace, 4, seed=1)

    def drill(side, rt, clock):
        rt.warmup()
        golden = dict(rt.pool._golden)
        rt.run_until(2.0)
        p = rt.stats()["pool"]
        assert p["probe_mismatches"] >= 2
        assert p["cache_repairs"] == 1
        assert p["quarantines"] == 0
        # the repaired cache serves the golden probe again, bit for bit
        x, ext = rt.pool._probe_batch(16)
        y = np.asarray(rt.pool.executors[0](x, ext))
        assert np.array_equal(y[0], golden[16])
        out = rt.play(_trace(side, 200.0, 12, seed=3, sizes=(16,)), images)
        assert len(out) == 12

    _same_story(_both(drill, 2, faults=[dict(t=0.5, kind="cache_corrupt")],
                      probe_interval_s=0.3), images)


def test_slow_replica_is_quarantined_by_probes():
    trace = rt_mod.poisson_trace(200.0, 12, seed=3, sizes=(16,))
    images = rt_mod.make_images(trace, 4, seed=1)

    def drill(side, rt, clock):
        rt.warmup()
        rt.run_until(1.0)
        p = rt.stats()["pool"]
        assert p["quarantines"] == 1
        assert p["states"].get("quarantined") == 1
        rt.play(_trace(side, 200.0, 12, seed=3, sizes=(16,)), images)
        assert _accounting(rt)["served"] == 12

    _same_story(_both(drill, 2, faults=[dict(t=0.1, kind="slow", replica=1, factor=8.0)],
                      probe_interval_s=0.2, slow_quarantine_factor=2.5), images)


# The --smoke day of `benchmarks/fleet_bench.py` (seed 11) with its fault
# drill: the scenario `chip_smoke.py` phase 12 replays on vgg at 64 px,
# here on the test net at 16 px.  The service model charges by rows, not
# by net or size, so the simulated story is the card's too.
DAY_S, DAY_REQUESTS, DAY_SEED = 60.0, 6000, 11
DAY_DRILL = [dict(t=DAY_S * 0.30, kind="crash", replica=0),
             dict(t=DAY_S * 0.50, kind="cache_corrupt"),
             dict(t=DAY_S * 0.65, kind="slow", replica=1, factor=8.0)]


def _day_trace(side):
    m = PKGS[side].rt
    base = m.diurnal_trace(DAY_REQUESTS / (DAY_S * 0.72), DAY_REQUESTS, seed=DAY_SEED,
                           depth=0.8, period_s=DAY_S, sizes=(12, 16), deadline_s=None)
    bursts = m.burst_trace(max(DAY_REQUESTS // 10, 40), burst=max(DAY_REQUESTS // 50, 20),
                           period_s=DAY_S / 8, seed=DAY_SEED + 1, sizes=(16,))
    return [a for a in m.merge_traces(base, bursts) if a.t <= DAY_S * 1.5]


def test_smoke_day_fault_drill_matches_the_reference():
    """The whole day tells the reference's story (equal autoscaler
    events, fired faults, losses, counters and simulated latencies) and
    passes phase 12's drill gates: the crash fires, the corruption is
    repaired once, the slowed replica is quarantined, the fleet scales,
    and SLO attainment is >= 0.95.  The trace ends before the last
    fault, so the fleet runs on, idle, through it and the probe that
    sees it."""
    trace = _day_trace("port")
    assert [tuple(vars(a).values()) for a in trace] == [
        tuple(vars(a).values()) for a in _day_trace("reference")]
    images = rt_mod.make_images(trace, 4, seed=1)
    cfg = dict(max_batch=8, buckets=(16,), queue_depth=512, slo_s=0.5,
               service_est_s=SERVICE["base_s"] + 8 * SERVICE["per_image_s"])
    auto = dict(min_replicas=2, max_replicas=6, tick_interval_s=DAY_S / 200,
                cooldown_s=DAY_S / 50, queue_high=6.0, queue_low=0.5,
                slack_min_s=0.05, admission_queue_per_replica=256.0)

    def day(side, rt, clock):
        rt.warmup()
        t0 = clock.now()
        for a in _day_trace(side):
            rt.run_until(t0 + a.t)
            rt.submit(images[a.rid], rid=a.rid, priority=a.priority,
                      deadline_s=a.deadline_s)
            if len(rt.results) > 4096:
                rt.results.clear()
        rt.drain()
        makespan = clock.now() - t0
        rt.run_until(t0 + max(f["t"] for f in DAY_DRILL) + DAY_S / 20)
        return makespan

    runs = _both(day, 2, cfg=cfg, autoscaler=auto, faults=DAY_DRILL,
                 startup_s=DAY_S / 100, probe_interval_s=DAY_S / 20, max_replicas=6)
    assert runs["port"][2] == runs["reference"][2]
    doc = _same_story(runs)
    c, p, a_st = doc["counters"], doc["pool"], doc["autoscaler"]
    assert c["admitted"] == c["images"] + c.get("lost_images", 0)
    assert len(trace) == c["admitted"] + c.get("rejected", 0)
    assert 1.0 - c.get("deadline_miss", 0) / c["images"] >= 0.95
    assert p["failures"] >= 1
    assert p["cache_repairs"] == 1 and p["probe_mismatches"] >= 1
    slowed = [r for r in p["per_replica"] if r["idx"] == 1]
    assert p["quarantines"] == 1
    assert slowed[0]["state"] == "quarantined" and slowed[0]["slow_factor"] == 8.0
    assert a_st["scale_ups"] + a_st["replacements"] >= 1
    assert [f["kind"] for f in p["faults"]["fired"]] == ["crash", "cache_corrupt", "slow"]


def test_no_healthy_replica_losses_resolve_immediately():
    def drill(side, rt, clock):
        rt.warmup()
        clock.advance(0.01)
        rt.pool.advance(clock.now())
        for i in range(4):
            rt.submit(IMG, rid=i, deadline_s=0.05)
        rt.drain()
        acct = _accounting(rt)
        assert acct["served"] == 0 and acct["lost"] == 4
        assert set(rt.losses.values()) == {fleet.LOSS_NO_HEALTHY_REPLICA}

    _same_story(_both(drill, 1, faults=[dict(t=0.001, kind="crash", replica=0)]))


# ---------------------------------------------------------- telemetry


def test_telemetry_schema_is_stable_across_scale_events():
    auto = dict(min_replicas=1, max_replicas=3, tick_interval_s=0.01, cooldown_s=0.05,
                queue_high=2.0, queue_low=0.1)

    def schema(doc):
        return set(doc), {k: set(v) for k, v in doc["latency"].items()}

    def drill(side, rt, clock):
        rt.warmup()
        for i in range(30):
            rt.submit(IMG, rid=i, deadline_s=5.0)
        rt.run_until(0.05)
        s0 = schema(rt.stats())
        rt.run_until(0.2)
        s1 = schema(rt.stats())
        rt.drain()
        s2 = schema(rt.stats())
        assert s0[0] == s1[0] == s2[0]
        for _, h in (s0, s1, s2):
            for keys in h.values():
                assert keys == {"count", "mean_s", "p50_s", "p95_s", "p99_s", "max_s"}
        doc = rt.stats()
        assert doc["counters"]["waves"] == doc["scheduler"]["waves"]
        acct = _accounting(rt)
        assert acct["served"] + acct["lost"] == 30
        return s0, s1, s2

    runs = _both(drill, 1, faults=[dict(t=0.08, kind="crash", replica=0)],
                 autoscaler=auto, startup_s=0.1)
    _same_story(runs)
    assert runs["port"][2] == runs["reference"][2]


def test_fleet_stats_sections_are_json_clean():
    def drill(side, rt, clock):
        rt.warmup()
        trace = _trace(side, 200.0, 8, seed=3, sizes=(16,))
        rt.play(trace, PKGS[side].rt.make_images(trace, 4, seed=1))
        doc = rt.stats()
        json.dumps(doc)
        assert {"pool", "scheduler", "cache", "autoscaler"} <= set(doc)
        assert doc["autoscaler"]["ticks"] >= 1
        assert doc["pool"]["states"] == {"ready": 1}

    _same_story(_both(drill, 1, autoscaler=dict(min_replicas=1, max_replicas=2,
                                                tick_interval_s=0.01)))


# ------------------------------------------------- the mesh's data axis


def _net():
    ws = cs.init_weights(SPEC, seed=5)
    return PKGS["port"].engine().compile(SPEC, ws, input_hw=(16, 16))


# each mesh with the shards an 8-row wave splits into: over (pod, data)
# where the rows divide their product, else over data (`batch_spec`)
MESH_SHAPES = [({"data": 8}, 8), ({"data": 2, "model": 4}, 2),
               ({"pod": 2, "data": 2, "model": 2}, 4)]


def _cpu_mesh(shape):
    """A mesh of CPU entries, the counterpart of the reference's forced
    host devices (`test_sharded_wave_on_forced_8_device_mesh`)."""
    return Mesh(shape, devices=["cpu"] * math.prod(shape.values()))


def _ragged_wave_of(n):
    """`n` seeded rows (any n), ragged extents among them."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, 16, 16, 4)) * 0.1).astype(np.float32)
    ext = np.array([[16, 16], [12, 12], [16, 14], [8, 16]] * (n // 4 + 1), np.int32)[:n]
    return x, ext


@pytest.mark.parametrize("shape,n_shards", MESH_SHAPES)
def test_data_axis_beyond_one_card_takes_the_mesh_path(shape, n_shards):
    """The counterpart of `test_sharded_wave_on_forced_8_device_mesh`: a
    wave whose rows divide the data axis runs on the mesh path (counted),
    within SHARD_TOL of the unsharded wave and of the reference's
    unsharded wave at the same weights and input; a wave whose rows do
    not divide takes the logical path (counted too)."""
    mesh = _cpu_mesh(shape)
    engine = PKGS["port"].engine()
    ws = cs.init_weights(SPEC, seed=5)
    net = engine.compile(SPEC, ws, input_hw=(16, 16))
    x, ext = _ragged_wave_of(8)
    y_ref = net(x, ext).numpy()
    sh = fleet.ShardedWaveExecutor(
        engine.compile(SPEC, ws, plan=net.plan, input_hw=(16, 16)), shards=8, mesh=mesh)
    y = sh(x, ext)
    assert isinstance(y, torch.Tensor) and y.shape == y_ref.shape
    assert sh.stats()["sharded_waves"] == {"mesh": 1, "logical": 0, "whole": 0}
    assert _rel(y.numpy(), y_ref) <= SHARD_TOL
    ref_net = PKGS["reference"].engine().compile(
        REF_SPEC, ref_cs.init_weights(REF_SPEC, seed=5), input_hw=(16, 16))
    assert _rel(y.numpy(), np.asarray(ref_net(x, ext))) <= SHARD_TOL
    x5, ext5 = _ragged_wave_of(5)
    assert _rel(sh(x5, ext5).numpy(), net(x5, ext5).numpy()) <= SHARD_TOL
    assert sh.stats()["sharded_waves"] == {"mesh": 1, "logical": 1, "whole": 0}
    # one call a shard: the mesh wave's n_shards, then the logical wave's
    # five rows in five shards; on a mesh of CPU entries every group's
    # first card is the replica's own, so no card net was made
    assert sh.executor.calls == n_shards + 5
    assert sh.stats()["card_calls"] == {}


def test_one_card_mesh_takes_the_logical_path():
    """A data axis of 1 (or no mesh) shards logically: the same outputs
    as no mesh, and placement moves nothing (every layer skipped)."""
    mesh = Mesh({"data": 1, "model": 1}, devices=["cpu"])
    net = _net()
    x, ext = _ragged_wave()
    net(x, ext)
    y_ref = net(x, ext).numpy()
    sh = fleet.ShardedWaveExecutor(net, shards=5, mesh=mesh)
    assert _rel(sh(x, ext).numpy(), y_ref) <= SHARD_TOL
    placement = fleet.plan_weight_placement(net, threshold_bytes=1)
    counts = fleet.apply_placement(net, mesh, placement)
    assert counts == {"sharded": 0, "replicated": 0, "skipped": len(placement)}
    assert counts == ref_fleet.apply_placement(None, None, placement)
    assert fleet.apply_placement(net, None, placement) == counts
    with pytest.raises(ValueError, match="shards must be >= 1"):
        fleet.ShardedWaveExecutor(net, shards=0)


@pytest.mark.parametrize("shape,n_shards", MESH_SHAPES)
def test_placement_on_a_cpu_mesh_moves_bytes_and_keeps_the_outputs(shape, n_shards):
    """The placement half of `test_sharded_wave_on_forced_8_device_mesh`:
    at threshold 1 every transform layer is placed (sharded + replicated
    >= 1), the mesh wave's outputs do not change, and under SHARD every
    mesh position keeps 1/N of the layer's bytes (N the data axis); a
    REPLICATE placement keeps the whole layer at every position.  Reads
    hand back the whole transform, bitwise the unplaced one."""
    mesh = _cpu_mesh(shape)
    ndata = shape["data"]
    engine = PKGS["port"].engine()
    ws = cs.init_weights(SPEC, seed=5)
    net = engine.compile(SPEC, ws, input_hw=(16, 16))
    x, ext = _ragged_wave_of(8)
    y_ref = net(x, ext).numpy()
    sh = fleet.ShardedWaveExecutor(
        engine.compile(SPEC, ws, plan=net.plan, input_hw=(16, 16)), shards=8, mesh=mesh)
    y0 = sh(x, ext).numpy()
    before = {k: net.cache._store[k].clone() for k in net.cache_keys()}
    for threshold, kind in ((1, fleet.SHARD), (1 << 40, fleet.REPLICATE)):
        placement = fleet.plan_weight_placement(net, threshold_bytes=threshold)
        counts = fleet.apply_placement(net, mesh, placement)
        assert counts["sharded"] + counts["replicated"] >= 1, counts
        assert counts["sharded" if kind == fleet.SHARD else "replicated"] == len(before)
        assert np.array_equal(sh(x, ext).numpy(), y0)
        assert _rel(y0, y_ref) <= SHARD_TOL
        for key, whole in before.items():
            entry = net.cache._store[key]
            assert isinstance(entry, cache_mod.PlacedTransform)
            assert entry.sharded == (kind == fleet.SHARD)
            share = whole.nbytes // ndata if kind == fleet.SHARD else whole.nbytes
            assert [entry.bytes_at(i) for i in range(mesh.size)] == [share] * mesh.size
            assert torch.equal(entry.on("cpu"), whole)
            assert net.cache.entry_nbytes(key) == whole.nbytes
        stats = net.cache.placement_stats()
        assert stats["sharded" if kind == fleet.SHARD else "replicated"] == len(before)
        # positions on one card share what they hold: the CPU keeps every
        # slice once, the whole stack's bytes
        assert stats["resident_bytes"] == {"cpu": sum(w.nbytes for w in before.values())}
        assert stats["gathers"] == stats["copies"] == 0


def test_sharded_placement_gathers_slices_from_their_cards():
    """A transform sharded over entries on two devices (the CPU and the
    meta device, which holds no values) keeps each slice on its own
    device and counts a read that must fetch another device's slice as a
    gather of that slice's bytes; a read on a device outside the mesh
    raises."""
    net, cache = _warm_cache()
    key = net.cache_keys()[-1]
    whole = cache._store[key]
    dim = whole.ndim - 1
    entry = cache_mod.PlacedTransform(whole, ["cpu", "meta"], [0, 1], dim)
    assert entry.resident_bytes() == {"cpu": whole.nbytes // 2, "meta": whole.nbytes // 2}
    assert entry.gathered_bytes("cpu") == whole.nbytes // 2
    assert entry.cards == {torch.device("cpu"), torch.device("meta")}
    with pytest.raises(ValueError, match="not cuda"):
        entry.on("cuda:3")
    replicated = cache_mod.PlacedTransform(whole, ["cpu", "cpu"], [0, 0], None)
    assert replicated.on("cpu") is whole and replicated.gathered_bytes("cpu") == 0
    with pytest.raises(ValueError):
        cache_mod.PlacedTransform(whole, ["cpu", "cpu"], [0, 1], None)


def test_a_sharded_read_is_a_transient_buffer():
    """A sharded entry read whole is a fresh buffer marked transient (the
    tile engine packs it for that call alone), bitwise the whole; a
    replicated entry's read is its resident copy, not transient."""
    from repro_torch.core.device import is_transient

    net, cache = _warm_cache()
    whole = cache._store[net.cache_keys()[-1]]
    sharded = cache_mod.PlacedTransform(whole, ["cpu", "cpu"], [0, 1], whole.ndim - 1)
    got = sharded.on("cpu")
    assert is_transient(got) and torch.equal(got, whole) and got is not sharded.on("cpu")
    replicated = cache_mod.PlacedTransform(whole, ["cpu", "cpu"], [0, 0], None)
    assert not is_transient(replicated.on("cpu"))


def test_unplaced_entry_is_copied_once_to_another_card():
    """An unplaced entry read on another device than its own (the meta
    device here) is copied there once and the copy kept beside it: a
    second read returns that copy and counts nothing; the resident bytes
    show it; placing or dropping the entry drops the copy."""
    net, cache = _warm_cache()
    key = net.cache_keys()[-1]
    whole = cache._store[key]
    first = cache._serve(key, whole, "meta")
    assert first.device.type == "meta" and first.shape == whole.shape
    assert cache._serve(key, whole, "meta") is first
    stats = cache.placement_stats()
    assert stats["copies"] == 1 and stats["moved_bytes"] == whole.nbytes
    assert stats["resident_bytes"]["meta"] == whole.nbytes
    assert cache.place(key, lambda wt: wt.clone())
    assert "meta" not in cache.placement_stats()["resident_bytes"]
    again = cache._serve(key, cache._store[key], "meta")
    assert again is not first and cache.placement_stats()["copies"] == 2
    assert cache.invalidate_keys([key]) == 1
    assert "meta" not in cache.placement_stats()["resident_bytes"]


def test_elastic_pool_on_a_cpu_mesh_matches_one_replica_with_one_shard():
    """Two replicas built with a 4-entry data mesh serve a ragged trace:
    full waves take the mesh path, partial ones the logical path, and
    every request is within SHARD_TOL of one replica with one shard."""
    trace = rt_mod.poisson_trace(45.0, 40, seed=7, sizes=(8, 12, 16), deadline_s=0.08)
    images = rt_mod.make_images(trace, 4, seed=1)
    cfg = dict(buckets=(16,), max_batch=4, queue_depth=128, slo_s=0.1,
               service_est_s=0.01)
    mesh = _cpu_mesh({"data": 4})
    runs = {}
    for n, shards, kw in ((2, 4, {"mesh": mesh}), (1, 1, {})):
        rt, _ = _fleet("port", n, shards=shards, cfg=cfg, **kw)
        rt.warmup([2, 4])
        runs[n] = (rt, rt.play(trace, images))
    (rt, out), (_, oracle) = runs[2], runs[1]
    assert out.keys() == oracle.keys() == {a.rid for a in trace} and not rt.errors
    for rid in oracle:
        assert _rel(out[rid], oracle[rid]) <= SHARD_TOL, rid
    waves = [ex.stats()["sharded_waves"] for ex in rt.pool.executors]
    assert sum(w["mesh"] for w in waves) >= 1 and sum(w["logical"] for w in waves) >= 1
    assert rt.stats()["scheduler"]["partial_waves"] >= 1


# ------------------------------------------------ the cache's fleet surface


def _warm_cache():
    net = _net()
    net(np.zeros((1, 16, 16, 4), np.float32))
    return net, net.cache


def test_cache_entry_nbytes_matches_the_reference():
    net, cache = _warm_cache()
    ref_net = PKGS["reference"].engine().compile(
        REF_SPEC, ref_cs.init_weights(REF_SPEC, seed=5), input_hw=(16, 16))
    ref_net(np.zeros((1, 16, 16, 4), np.float32))
    got = {k[1]: cache.entry_nbytes(k) for k in net.cache_keys()}
    want = {k[1]: ref_net.cache.entry_nbytes(k) for k in ref_net.cache_keys()}
    assert got == want and all(v > 0 for v in got.values())
    assert cache.entry_nbytes(("no", "such", "key")) is None


def test_cache_place_refuses_shape_dtype_and_device_changes():
    """Placement never changes what is served: a plain tensor must keep
    shape, dtype and device; a device change is taken only as a mesh
    placement (`PlacedTransform`) whose whole transform is bitwise the
    entry's, and an entry placed so is placed again from its whole."""
    net, cache = _warm_cache()
    key = net.cache_keys()[-1]
    before = cache._store[key]
    assert cache.place(key, lambda wt: wt.clone())
    assert torch.equal(cache._store[key], before)
    assert not cache.place(("no", "such", "key"), lambda wt: wt)
    for bad in (lambda wt: wt.reshape(-1), lambda wt: wt.to(torch.float64),
                lambda wt: wt.to("meta"),
                lambda wt: cache_mod.PlacedTransform(wt.to("meta"), ["meta"], [0], None)):
        with pytest.raises(ValueError, match="placement changed entry"):
            cache.place(key, bad)
    dim = before.ndim - 1

    def tampered(wt):
        placed = cache_mod.PlacedTransform(wt, ["cpu", "cpu"], [0, 1], dim)
        placed._held[(torch.device("cpu"), 1)] += 1.0
        return placed

    with pytest.raises(ValueError, match="values"):
        cache.place(key, tampered)
    assert cache.place(key, lambda wt: cache_mod.PlacedTransform(wt, ["cpu"] * 2, [0, 1], dim))
    assert cache.place(key, lambda wt: torch.equal(wt, before) and wt.clone())
    assert torch.equal(cache._store[key], before)


def test_cache_corrupt_entry_negates_a_new_tensor():
    net, cache = _warm_cache()
    lru = cache.keys()[0]
    old = cache._store[lru]
    kept = old.clone()
    assert cache.corrupt_entry() == lru
    assert torch.equal(cache._store[lru], -kept)
    assert torch.equal(old, kept)  # the old tensor was not written into
    assert cache.corrupt_entry(("no", "such", "key")) is None
    cache.invalidate()
    assert cache.corrupt_entry() is None  # empty cache


# ------------------------------------------- the real clock and hot swap


def test_realclock_pool_runs_inline_and_times_after_the_host_copy():
    """Under a RealClock the pool executes on the caller's thread: a
    submitted wave's future is resolved on return, its compute time is
    the measured wall time, and the outputs are the SimClock fleet's."""
    trace = rt_mod.poisson_trace(45.0, 12, seed=7, sizes=(8, 12, 16), deadline_s=0.08)
    images = rt_mod.make_images(trace, 4, seed=1)
    engine = PKGS["port"].engine()
    pool = fleet.ElasticPool.build(engine, SPEC, cs.init_weights(SPEC, seed=5), n=2,
                                   input_hw=(16, 16), shards=2)
    assert pool.clock.realtime
    rt = fleet.FleetRuntime(pool, rt_mod.RuntimeConfig(
        buckets=(16,), max_batch=4, queue_depth=128, slo_s=0.1, service_est_s=0.01))
    rt.warmup([2, 4])
    out = rt.play(trace, images)
    doc = rt.stats()
    assert set(out) == {a.rid for a in trace} and not rt.errors
    assert doc["pool"]["in_flight"] == 0
    assert doc["latency"]["compute"]["count"] + doc["latency"].get(
        "compute_cold", {"count": 0})["count"] == doc["counters"]["waves"]
    for a in trace:
        assert _rel(out[a.rid], _oracle(images[a.rid])) < ORACLE_TOL


def test_warm_workers_runs_every_wave_through_every_executor():
    rt, _ = _fleet("port", 2)
    pool = rt.pool
    exs = pool.executors
    calls = [ex.net.executor.calls for ex in exs]
    waves = [(np.zeros((s, 16, 16, 4), np.float32), np.zeros((s, 2), np.int32))
             for s in (1, 4)]
    pool.warm_workers(exs, waves)
    assert [ex.net.executor.calls for ex in exs] == [c + 2 for c in calls]


def test_autoscaler_config_validates():
    for kw in (dict(min_replicas=0), dict(queue_high=1.0, queue_low=2.0),
               dict(min_replicas=4, max_replicas=2)):
        with pytest.raises(ValueError):
            fleet.AutoscalerConfig(**kw)
        with pytest.raises(ValueError):
            ref_fleet.AutoscalerConfig(**kw)


def test_autoscaler_hysteresis_and_cooldown():
    cfg = dict(min_replicas=1, max_replicas=3, tick_interval_s=0.1,
               cooldown_s=10.0, queue_high=4.0, queue_low=0.5)

    def drill(side, rt, clock):
        m = PKGS[side]
        depth = {"v": 100}
        auto = m.fleet.Autoscaler(rt.pool, m.fleet.AutoscalerConfig(**cfg),
                                  queue_depth_fn=lambda: depth["v"])
        clock.advance(0.15)
        acts = [auto.tick(clock.now())]
        rt.pool.advance(clock.now() + 0.02)
        clock.advance(0.15)
        acts.append(auto.tick(clock.now()))
        acts.append(auto.tick(clock.now()))
        s = auto.stats()
        assert acts == ["up", None, None]
        assert s["scale_ups"] == 1 and s["events"][0]["action"] == "up"
        return s

    runs = _both(drill, 1, startup_s=0.01)
    assert runs["port"][2] == runs["reference"][2]
