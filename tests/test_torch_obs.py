"""The port's flight recorder and live roofline (`repro_torch.convserve.obs`)
against the reference's, on the CPU.

The same span operations under one `SimClock` must give equal span-tree
signatures in both packages (names, categories, nesting, simulated
times; the backend/geometry args of tile-phase instants are each
package's own); `attribute_stage`'s FLOP and byte terms must equal the
reference's exactly for the same program, hardware model and seconds.
The autoscaler's stale-telemetry guard and the acceptance drill (one
tracer across a faulted fleet run and an adapt hot swap) give the same
decisions, audit events and span trees as the reference's.
"""

import json
import threading

import numpy as np
import pytest

from repro import convserve as ref_cs
from repro.configs.convnets import tiny_testnet as ref_tiny_testnet
from repro.convserve import obs as ref_obs
from repro.convserve import runtime as ref_rt
from repro.convserve.obs import roofline as ref_rf
from repro.core import analysis as ref_analysis
from repro_torch import convserve as cs
from repro_torch.configs.convnets import tiny_testnet
from repro_torch.convserve import obs
from repro_torch.convserve import runtime as rt_mod
from repro_torch.convserve.check.diagnostics import CheckReport, Diagnostic, VerificationError
from repro_torch.convserve.obs import roofline as rf
from repro_torch.core import analysis, registry

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
SPEC, REF_SPEC = tiny_testnet(4), ref_tiny_testnet(4)
PACKAGES = {"port": (obs, rt_mod), "reference": (ref_obs, ref_rt)}


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _spans(events):
    return [e for e in events if hasattr(e, "sid")]


def _instants(events):
    """(name, cat, t) per instant: args left out (a tile phase carries
    each package's backend and launch geometry)."""
    return [(e.name, e.cat, round(e.t, 9)) for e in events if not hasattr(e, "sid")]


# ------------------------------------------------------------ span recorder


def _scripted(o, m, **tracer_kw):
    """One fixed sequence of span operations on `o`'s Tracer."""
    clock = m.SimClock()
    t = o.Tracer(clock=clock, **tracer_kw)
    for i in range(6):
        with t.span(f"root:{i}", o.CAT_REQUEST, rid=i):
            clock.advance(0.001)
            with t.span(f"child:{i}", o.CAT_WAVE):
                t.instant(f"tick:{i}", o.CAT_WAVE)
                clock.advance(0.002)
            sid = t.begin(f"explicit:{i}", o.CAT_STAGE, flow_in=(f"r{i}",))
            clock.advance(0.0005)
            t.end(sid, pid=i % 2, flow_out=(f"w{i}",), done=True)
    return t


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.25])
def test_span_operations_give_the_reference_signature(rate):
    """Nesting, explicit begin/end with late-bound pid, instants and
    deterministic root sampling: equal signatures, instants and stats."""
    a = _scripted(obs, rt_mod, sample_rate=rate)
    b = _scripted(ref_obs, ref_rt, sample_rate=rate)
    assert obs.span_tree_signature(a.events()) == ref_obs.span_tree_signature(b.events())
    assert _instants(a.events()) == _instants(b.events())
    assert a.stats() == b.stats()
    assert a.open_count() == 0


def test_sampling_drops_whole_subtrees():
    t = _scripted(obs, rt_mod, sample_rate=0.5)
    spans = _spans(t.events())
    roots = [s for s in spans if not s.parent]
    kids = [s for s in spans if s.parent]
    # half of the six roots survive, each with both of its children (the
    # explicit span begun inside a root is its child too)
    assert len(roots) == 3 and len(kids) == 6
    assert {k.parent for k in kids} == {r.sid for r in roots}
    # a dropped root takes its instants with it
    assert len(_instants(t.events())) == 3
    assert t.stats()["sampled_out"] == 3


def test_explicit_end_on_another_thread_late_binds_args():
    clock = rt_mod.SimClock()
    t = obs.Tracer(clock=clock)
    sid = t.begin("wave:b16", obs.CAT_WAVE, batch=4)
    clock.advance(0.004)
    th = threading.Thread(target=lambda: t.end(sid, pid=3, flow_out=("w1",), compute_s=0.004))
    th.start()
    th.join(5.0)
    (s,) = _spans(t.events())
    assert s.pid == 3 and s.flow_out == ("w1",) and s.dur == pytest.approx(0.004)
    assert s.args == {"batch": 4, "compute_s": 0.004}
    t.end(sid)
    t.end(0)
    assert len(t.events()) == 1


@pytest.mark.parametrize("capacity", [1, 16, 49])
def test_ring_capacity_and_drops_match_reference(capacity):
    stats = []
    for o, m in PACKAGES.values():
        t = o.Tracer(clock=m.SimClock(), capacity=capacity)
        for i in range(50):
            with t.span(f"s:{i}", o.CAT_REQUEST):
                pass
        assert len(t.events()) == capacity
        stats.append(t.stats())
    assert stats[0] == stats[1]
    assert stats[0]["dropped"] == 50 - capacity


def test_disabled_and_null_tracers_record_nothing():
    t = obs.Tracer(clock=rt_mod.SimClock(), enabled=False)
    with t.span("x", obs.CAT_REQUEST):
        t.instant("y", obs.CAT_WAVE)
    assert t.events() == [] and t.open_count() == 0
    n = obs.NULL_TRACER
    assert not n.active and n.begin("x") == 0 and n.stats() == {"enabled": False}
    with n.span("x"), n.flow("f"):
        pass


# ------------------------------------------------------- a traced serve run


def _traced_serve_run(o, m, cs_mod, spec, hw, **engine_kw):
    clock = m.SimClock()
    tracer = o.Tracer(clock=clock)
    pool = m.ReplicaPool.build(cs_mod.Engine(hw=hw, **engine_kw), spec,
                               cs_mod.init_weights(spec, seed=5), n=1, workers=0,
                               input_hw=(16, 16))
    cfg = m.RuntimeConfig(max_batch=2, buckets=(16,), slo_s=1.0, service_est_s=1e-4)
    rt = m.ServeRuntime(pool, cfg, clock=clock, tracer=tracer)
    rt.warmup()
    rng = np.random.default_rng(11)
    for i in range(6):
        rt.submit((rng.standard_normal((16, 16, 4)) * 0.1).astype(np.float32), rid=i)
        rt.poll()
    rt.drain()
    doc = rt.stats(profile_bucket=16)
    rt.pool.shutdown()
    return tracer, doc


def _port_run():
    return _traced_serve_run(obs, rt_mod, cs, SPEC, analysis.HardwareModel(**_BIG),
                             device="cpu")


def test_traced_serve_run_matches_the_reference_span_tree():
    """Requests, waves, the profile sweep with its stage spans and the
    tile phases announced inside them, and the roofline instants: the
    same tree at the same simulated times as the reference's."""
    a, doc = _port_run()
    b, ref_doc = _traced_serve_run(ref_obs, ref_rt, ref_cs, REF_SPEC,
                                   ref_analysis.HardwareModel(**_BIG))
    sig = obs.span_tree_signature(a.events())
    assert sig == ref_obs.span_tree_signature(b.events()) and sig
    assert _instants(a.events()) == _instants(b.events())
    names = {s.name for s in _spans(a.events())}
    assert {"profile_stages"} <= names
    assert any(n.startswith("request:") for n in names)
    assert any(n.startswith("wave:") for n in names)
    assert any(n.startswith("stage:") for n in names)
    phases = [e for e in a.events() if getattr(e, "cat", None) == obs.CAT_PHASE]
    assert phases and all(e.args["backend"] == "torch-cpu" for e in phases)
    assert doc["trace"]["recorded"] == ref_doc["trace"]["recorded"]
    assert a.open_count() == 0
    # a second identical run gives the same signature
    assert obs.span_tree_signature(_port_run()[0].events()) == sig


def test_phases_fire_in_profiling_only():
    """Served waves announce no tile phase; each profiled stage's
    untimed warm call does, once per logical phase and dispatch."""
    from repro_torch.kernels.fused_tile import ops as tile_ops

    a, _ = _port_run()
    stage_sids = {s.sid for s in _spans(a.events()) if s.name.startswith("stage:")}
    assert stage_sids
    phases = [e.name for e in a.events() if getattr(e, "cat", None) == obs.CAT_PHASE]
    assert len(phases) % len(tile_ops._PHASES) == 0
    assert phases[:5] == [f"phase:{p}" for p in tile_ops._PHASES]
    assert tile_ops.set_phase_hook(None) is None  # restored after capture


# ------------------------------------------------------------ roofline math


def _nets():
    ws, ref_ws = cs.init_weights(SPEC, seed=5), ref_cs.init_weights(REF_SPEC, seed=5)
    hw, ref_hw = analysis.HardwareModel(**_BIG), ref_analysis.HardwareModel(**_BIG)
    net = cs.Engine(hw=hw, device="cpu").compile(SPEC, ws, input_hw=(16, 16))
    ref_net = ref_cs.Engine(hw=ref_hw).compile(REF_SPEC, ref_ws, input_hw=(16, 16))
    return net, hw, ref_net, ref_hw


@pytest.mark.parametrize("measured_s", [1e-4, 3.7e-6])
def test_attribute_stage_equals_the_reference_exactly(measured_s):
    net, hw, ref_net, ref_hw = _nets()
    assert len(net.program.stages) == len(ref_net.program.stages) > 0
    for stage, ref_stage in zip(net.program.stages, ref_net.program.stages):
        row = rf.attribute_stage(stage, measured_s, hw, batch=2, backend="b",
                                 predicted_s=2e-4)
        want = ref_rf.attribute_stage(ref_stage, measured_s, ref_hw, batch=2, backend="b",
                                      predicted_s=2e-4)
        assert row == want


def test_attribute_stage_matches_hand_computed_tile_algebra():
    net, hw, _, _ = _nets()
    stage = net.program.stages[0]
    row = rf.attribute_stage(stage, 1e-4, hw, batch=1, backend="torch-cpu")
    flops = dram = 0
    for u in stage.units:
        s = u.plan.spec
        ta = registry.get(u.plan.algo).tile_algebra(u.plan.algo_plan())
        assert ta is not None
        flops += ta.engine_flops(s.h + 2 * s.pad - s.k + 1, s.w + 2 * s.pad - s.k + 1,
                                 s.c_in, s.c_out, s.groups, 1)
        oh, ow = s.out_hw
        dram += 4 * (s.h * s.w * s.c_in + oh * ow * s.c_out)
        dram += ta.kernel_matrix_bytes(s.c_in, s.c_out, s.groups)
    assert row["flops"] == flops and row["dram_bytes"] == dram
    assert row["key"].startswith("torch-cpu:")
    assert sum(p["attributed_us"] for p in row["phases"]) == pytest.approx(row["measured_us"])


def test_verdict_bands_match_reference():
    net, hw, ref_net, ref_hw = _nets()
    stage, ref_stage = net.program.stages[0], ref_net.program.stages[0]
    probe = rf.attribute_stage(stage, 1.0, hw, backend="b")
    for frac, verdict in ((2.0, "above_model"), (0.8, "at_roof"), (0.2, "below_roof"),
                          (0.03, "far_below_roof")):
        secs = probe["flops"] / (frac * probe["roof_gflops"] * 1e9)
        got = rf.attribute_stage(stage, secs, hw, backend="b")["verdict"]
        assert got == ref_rf.attribute_stage(ref_stage, secs, ref_hw, backend="b")["verdict"]
        assert got == verdict
    assert (rf.LEVEL_DRAM, rf.LEVEL_SHARED, rf.LEVEL_PRIVATE) == (
        "dram", "shared_l3", "fast_private")


def test_roofline_section_schema_and_trace_instants():
    net, hw, _, _ = _nets()
    profile = net.profile_stages(np.zeros((1, 16, 16, 4), np.float32))
    tracer = obs.Tracer(clock=rt_mod.SimClock())
    sec = rf.roofline_section(net.program, profile, hw, batch=1, tracer=tracer)
    assert sec["schema_version"] == rf.SCHEMA_VERSION == ref_rf.SCHEMA_VERSION == 2
    assert set(sec) == {"schema_version", "hw", "batch", "stages"}
    assert set(sec["hw"]) == {"name", "peak_gflops", "dram_gbs", "fast_shared_gbs",
                              "cmr_dram", "cmr_fast"}
    assert len(sec["stages"]) == len(profile) > 0
    for row in sec["stages"]:
        assert row["achieved_gflops"] > 0
        assert row["key"].startswith("torch-cpu:")
    instants = [e for e in tracer.events() if getattr(e, "name", "") == "roofline.stage"]
    assert len(instants) == len(sec["stages"])
    table = obs.roofline_table(sec["stages"], hw_name=hw.name)
    assert table == ref_obs.roofline_table(sec["stages"], hw_name=hw.name)


# ------------------------------------------------------------------ export


def _flows(o, m):
    t = o.Tracer(clock=m.SimClock())
    r = t.begin("request:1", o.CAT_REQUEST, flow_out=("r1",))
    t.end(r)
    w = t.begin("wave:b16", o.CAT_WAVE, flow_in=("r1",))
    t.end(w, flow_out=("w1",))
    p = t.begin("profile", o.CAT_PROFILE, flow_in=("w1",))
    t.end(p)
    x = t.begin("wave:b32", o.CAT_WAVE, flow_in=("r_missing",))
    t.end(x, flow_out=("w_unconsumed",))
    t.instant("flight.trip", o.CAT_FLEET, reason="x")
    return t


def test_chrome_export_matches_reference_and_pairs_flows(tmp_path):
    t = _flows(obs, rt_mod)
    events = obs.chrome_trace_events(t.events(), process_names={0: "replica0"})
    want = ref_obs.chrome_trace_events(_flows(ref_obs, ref_rt).events(),
                                       process_names={0: "replica0"})
    assert events == want
    assert obs.validate_chrome_trace(events) == []
    flows = [e for e in events if e["ph"] in ("s", "f")]
    assert {e["name"] for e in flows} == {"r1", "w1"}
    n = obs.write_trace(t, tmp_path / "t.trace.json")
    doc = json.loads((tmp_path / "t.trace.json").read_text())
    assert len(doc) == n and obs.validate_chrome_trace(doc) == []


BAD_TRACES = {
    "not-a-list": {"no": "events"},
    "negative-dur": [{"ph": "X", "name": "s", "ts": 0.0, "dur": -1.0}],
    "lone-flow-start": [{"ph": "s", "name": "lone", "id": 9, "ts": 0.0}],
    "lone-flow-finish": [{"ph": "f", "name": "lone", "id": 3, "ts": 0.0}],
    "missing-name": [{"ph": "i", "ts": 0.0}],
    "complete-without-dur": [{"ph": "X", "name": "s", "ts": 0.0}],
}


@pytest.mark.parametrize("name", sorted(BAD_TRACES))
def test_validate_chrome_trace_flags_what_the_reference_flags(name):
    got = obs.validate_chrome_trace(BAD_TRACES[name])
    assert got == ref_obs.validate_chrome_trace(BAD_TRACES[name]) and got


def test_prometheus_text_matches_reference():
    docs = []
    for _, m in PACKAGES.values():
        tel = m.Telemetry(clock=m.SimClock())
        tel.inc("waves", 3)
        tel.inc("rejected.queue_full")
        tel.set_gauge("queue_depth", 7)
        tel.observe("e2e", 0.01)
        docs.append(tel.snapshot())
    text = obs.prometheus_text(docs[0], prefix="convserve")
    assert text == ref_obs.prometheus_text(docs[1], prefix="convserve")
    assert "convserve_waves_total 3" in text and "convserve_rejected_queue_full_total 1" in text


def test_flight_recorder_throttles_dumps_and_guards(tmp_path):
    t = obs.Tracer(clock=rt_mod.SimClock())
    with t.span("work", obs.CAT_REQUEST):
        pass
    tel = rt_mod.Telemetry(clock=rt_mod.SimClock())
    rec = obs.FlightRecorder(t, telemetry=tel, path_prefix=str(tmp_path / "ring"), max_dumps=2)
    paths = [rec.trip(obs.TRIP_SLO_BREACH) for _ in range(5)]
    assert sum(p is not None for p in paths) == 2
    assert rec.trip(obs.TRIP_WAVE_LOSS) is not None
    st = rec.stats()
    assert st["trips"] == {"slo_breach": 5, "wave_loss": 1} and len(st["dumps"]) == 3
    for p in st["dumps"]:
        doc = json.loads(open(p).read())
        assert obs.validate_chrome_trace(doc) == []
        assert any(e.get("ph") == "M" and e.get("name") == "telemetry" for e in doc)
    assert tel.snapshot()["counters"]["flight.trip.slo_breach"] == 5
    report = CheckReport(analyzer="test")
    report.add(Diagnostic(code="CVK101", message="boom"))
    with pytest.raises(VerificationError):
        with rec.guard():
            raise VerificationError(report)
    assert rec.stats()["trips"]["verification_error"] == 1
    assert obs.FlightRecorder(t).trip("x") is None  # no prefix: counts only


def test_runtime_trips_the_recorder_on_a_deadline_miss(tmp_path):
    """A wave that completes past its requests' deadline trips
    `slo_breach` once per wave and dumps the ring."""
    clock = rt_mod.SimClock()
    tracer = obs.Tracer(clock=clock)
    pool = rt_mod.ReplicaPool.build(
        cs.Engine(hw=analysis.HardwareModel(**_BIG), device="cpu"), SPEC,
        cs.init_weights(SPEC, seed=5), n=1, workers=0, input_hw=(16, 16))
    rec = obs.FlightRecorder(tracer, path_prefix=str(tmp_path / "rt"))
    rt = rt_mod.ServeRuntime(pool, rt_mod.RuntimeConfig(max_batch=4, buckets=(16,)),
                             clock=clock, tracer=tracer, recorder=rec)
    rng = np.random.default_rng(3)
    rt.submit((rng.standard_normal((16, 16, 4)) * 0.1).astype(np.float32), rid=0,
              deadline_s=0.01)
    clock.advance(0.02)
    rt.drain()
    assert rt.telemetry.counter("deadline_miss") == 1
    assert rec.stats()["trips"] == {"slo_breach": 1} and len(rec.stats()["dumps"]) == 1


# ------------------------------------------ the autoscaler's stale guard


class _PoolStub:
    """The minimal pool surface `Autoscaler.tick` touches."""

    startup_s = 0.0

    def __init__(self, clock, n=2):
        self.clock = clock
        self.n = n

    def ready_count(self):
        return self.n

    def live_count(self):
        return self.n

    def grow(self, k, now=None):
        self.n += k
        return list(range(k))

    def retire(self, k, now=None):
        self.n -= k
        return [0]

    def counts(self):
        return {}


def _fleet_mod(side):
    from repro.convserve import fleet as ref_fleet
    from repro_torch.convserve import fleet

    return (fleet, rt_mod) if side == "port" else (ref_fleet, ref_rt)


def _stale_up(side):
    f, m = _fleet_mod(side)
    clock = m.SimClock()
    tel = m.Telemetry(clock=clock)
    a = f.Autoscaler(
        _PoolStub(clock),
        f.AutoscalerConfig(max_replicas=8, tick_interval_s=1.0, cooldown_s=0.0,
                           queue_high=2.0, queue_low=1.0, require_fresh_telemetry=True),
        clock=clock, queue_depth_fn=lambda: 100, telemetry=tel,
    )
    tel.inc("traffic")  # fresh stamp before the first decision
    acts = []
    for _ in range(3):
        clock.advance(1.1)
        acts.append(a.tick(clock.now()))
    return acts, a.stats(), tel.snapshot()["counters"], list(a.events)


def test_autoscaler_blocks_stale_snapshot_scale_up():
    """A scale-up on a snapshot whose stamp has not advanced since the
    last decision is counted, audited and vetoed; the stale counter
    itself advances the stamp, so the guard clears on the next tick."""
    acts, st, counters, events = got = _stale_up("port")
    assert got == _stale_up("reference")
    assert acts == ["up", None, "up"]
    assert st["scale_ups"] == 2 and st["stale_decisions"] == 1
    assert counters["autoscaler.stale_snapshot"] == 1
    assert [e["action"] for e in events] == ["up", "stale:up", "up"]


def _replace_on_stale(side):
    f, m = _fleet_mod(side)
    clock = m.SimClock()
    tel = m.Telemetry(clock=clock)
    a = f.Autoscaler(
        _PoolStub(clock, n=0),  # total fleet loss
        f.AutoscalerConfig(min_replicas=1, tick_interval_s=1.0,
                           require_fresh_telemetry=True),
        clock=clock, telemetry=tel,
    )
    clock.advance(1.1)
    return a.tick(clock.now()), a.stats()


def test_autoscaler_replacement_is_exempt_from_stale_guard():
    act, st = got = _replace_on_stale("port")
    assert got == _replace_on_stale("reference")
    # stamp seq 0 never advanced, but replacement must act anyway
    assert act == "replace" and st["stale_decisions"] == 0 and st["replacements"] == 1


# ------------------------------------------------------------ acceptance


def _acceptance(side, tmp_path):
    """The reference's acceptance drill in one package: one tracer over
    (A) a SimClock fleet run through two replica crashes with retries
    exhausted (the recorder trips on the WaveLoss) and (B) an adapt
    controller's hot swap plus a stage profile."""
    import importlib

    port = side == "port"
    o, m, pkg = (obs, rt_mod, cs) if port else (ref_obs, ref_rt, ref_cs)
    f, _ = _fleet_mod(side)
    fault = importlib.import_module("repro_torch.runtime.fault" if port else "repro.runtime.fault")
    pl = importlib.import_module(
        "repro_torch.convserve.planner" if port else "repro.convserve.planner")
    spec = SPEC if port else REF_SPEC
    hw = (analysis if port else ref_analysis).HardwareModel(**_BIG)
    engine = pkg.Engine(hw=hw, device="cpu") if port else pkg.Engine(hw=hw)
    ws = pkg.init_weights(spec, seed=5)
    clock = m.SimClock()
    tracer = o.Tracer(clock=clock)
    recorder = o.FlightRecorder(tracer, path_prefix=str(tmp_path / f"{side}-drill"),
                                max_dumps=1)

    # (A) fleet drill: both replicas crash, retries exhausted -> losses
    fp = fault.FaultPlan([
        fault.ReplicaFault(t=0.010, kind=fault.FAULT_CRASH, replica=0),
        fault.ReplicaFault(t=0.012, kind=fault.FAULT_CRASH, replica=1),
    ], clock=clock)
    pool = f.ElasticPool.build(
        engine, spec, ws, n=2, clock=clock, input_hw=(16, 16), shards=1,
        service_model=f.FixedServiceModel(base_s=0.004, per_image_s=0.002),
        fault_plan=fp, max_retries=0,
    )
    cfg = m.RuntimeConfig(buckets=(16,), max_batch=4, queue_depth=256, slo_s=0.25,
                          service_est_s=0.012)
    frt = f.FleetRuntime(pool, cfg, clock=clock, tracer=tracer, recorder=recorder)
    frt.warmup()
    trace = m.poisson_trace(400.0, 24, seed=3, sizes=(16,), deadline_s=1.0)
    frt.play(trace, m.make_images(trace, 4, seed=1))
    fleet_doc = frt.stats()

    # (B) adapt hot swap + stage profile on the SAME tracer
    pool2 = m.ReplicaPool.build(engine, spec, ws, n=1, workers=0, input_hw=(16, 16))
    srt = m.ServeRuntime(pool2, m.RuntimeConfig(max_batch=2, buckets=(16,), slo_s=1.0,
                                                service_est_s=1e-4),
                         clock=clock, tracer=tracer)

    def probe(net, bucket, batch):
        preds = pl.predict_stage_times(net.program, engine.hw)
        return [(label, pred * (10.0 if st.fused else
                                1000.0 if st.units[0].plan.algo == "direct" else 1.0))
                for st, (label, pred) in zip(net.program.stages, preds)]

    ac = pkg.AdaptController(
        srt, engine, spec, ws,
        pkg.AdaptConfig(divergence_ratio=2.0, shadow_fraction=1.0, shadow_min_waves=2,
                        cooldown_s=0.5),
        probe=probe, shadow_timer=lambda res, cand_s: (0.010, 0.004),
    )
    ac.measure()
    ac.probe_alternatives()
    trigger = ac.check()
    rng = np.random.default_rng(3)
    for i in range(1000, 1008):
        srt.submit((rng.standard_normal((16, 16, 4)) * 0.1).astype(np.float32), rid=i)
        srt.poll()
    srt.drain()
    doc = srt.stats(profile_bucket=16)
    srt.pool.shutdown()
    out = tmp_path / f"{side}-acceptance.trace.json"
    n = o.write_trace(tracer, str(out))
    return dict(tracer=tracer, recorder=recorder.stats(), fleet=fleet_doc, trigger=trigger,
                promotions=ac.promotions, audit=[(a["event"], a["reason"]) for a in ac.audit],
                losses=dict(frt.losses), roof=doc["roofline"], n=n,
                events=json.loads(out.read_text()), o=o)


def test_acceptance_faulted_fleet_plus_hot_swap_trace(tmp_path):
    """One tracer follows a faulted fleet and a hot swap, then exports
    one valid Chrome trace with request->wave flows and a roofline
    verdict per stage -- the same story, span tree and instants as the
    reference's."""
    got, want = _acceptance("port", tmp_path), _acceptance("reference", tmp_path)
    assert got["recorder"]["trips"] == want["recorder"]["trips"]
    assert got["recorder"]["trips"].get("wave_loss", 0) >= 1
    assert len(got["recorder"]["dumps"]) == len(want["recorder"]["dumps"]) == 1
    assert got["losses"] == want["losses"] and got["losses"]
    assert got["fleet"]["counters"] == want["fleet"]["counters"]
    assert got["fleet"]["pool"]["faults"] == want["fleet"]["pool"]["faults"]
    assert got["trigger"] is not None and want["trigger"] is not None
    assert got["audit"] == want["audit"] and got["promotions"] == want["promotions"] == 1
    sig = obs.span_tree_signature(got["tracer"].events())
    assert sig == ref_obs.span_tree_signature(want["tracer"].events()) and sig
    assert _instants(got["tracer"].events()) == _instants(want["tracer"].events())
    roof = got["roof"]
    assert roof is not None and roof["schema_version"] == want["roof"]["schema_version"]
    assert [r["stage"] for r in roof["stages"]] == [r["stage"] for r in want["roof"]["stages"]]
    for row in roof["stages"]:
        assert row["achieved_gflops"] > 0
        assert row["binding_level"] in ("dram", "shared_l3", "fast_private")
        assert row["verdict"] in ("above_model", "at_roof", "below_roof", "far_below_roof")
    assert got["tracer"].open_count() == 0
    events = got["events"]
    assert obs.validate_chrome_trace(events) == []
    assert len(events) == got["n"] > 0
    assert {"X", "s", "f", "i"} <= {e["ph"] for e in events}
    names = {e["name"] for e in events}
    assert names == {e["name"] for e in want["events"]}
    assert any(nm.startswith("request:") for nm in names)
    assert any(nm.startswith("wave:") for nm in names)
    assert {"fleet.fault", "flight.trip", "adapt.promote", "roofline.stage"} <= names
    assert "profile_stages" in names
