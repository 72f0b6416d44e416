"""The port's online serving runtime (`repro_torch.convserve.runtime`)
against the reference's, on the CPU.

The same seeded traces must be equal element for element; the same
traffic under one `SimClock` must form the same waves (bucket, padded
batch, rids, flush reason) and count the same counters and telemetry
keys in both packages; served outputs agree within rel 1e-4 (both fp32,
different summation orders) and stay within rel 1e-3 of the direct-conv
oracle (the reference's own net tolerance).  The fleet built on this
runtime is held in `tests/test_torch_fleet.py`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import convserve as ref_cs
from repro.configs.convnets import tiny_testnet as ref_tiny_testnet
from repro.convserve import runtime as ref_rt
from repro.core import analysis as ref_analysis
from repro_torch import convserve as cs
from repro_torch.configs.convnets import tiny_testnet
from repro_torch.convserve import runtime as rt_mod
from repro_torch.core import analysis

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
SPEC, REF_SPEC = tiny_testnet(4), ref_tiny_testnet(4)
SERVE_TOL = 1e-4  # port vs reference, both fp32
ORACLE_TOL = 1e-3  # vs the direct-conv oracle (the reference's own)


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    """Both packages plan from the model alone: an empty wisdom file."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-12))


def _image(rng, side: int, c: int = 4) -> np.ndarray:
    return (rng.standard_normal((side, side, c)) * 0.1).astype(np.float32)


def _pair(cfg: dict, *, n: int = 1, workers: int = 0, **compile_kwargs):
    """(reference runtime, port runtime): inline replicas and a SimClock
    each, the same weights (seed 5), the same hardware model."""
    ref_pool = ref_rt.ReplicaPool.build(
        ref_cs.Engine(hw=ref_analysis.HardwareModel(**_BIG)), REF_SPEC,
        ref_cs.init_weights(REF_SPEC, seed=5), n=n, workers=workers,
        input_hw=(16, 16), **compile_kwargs,
    )
    pool = rt_mod.ReplicaPool.build(
        cs.Engine(hw=analysis.HardwareModel(**_BIG), device="cpu"), SPEC,
        cs.init_weights(SPEC, seed=5), n=n, workers=workers,
        input_hw=(16, 16), **compile_kwargs,
    )
    ref = ref_rt.ServeRuntime(ref_pool, ref_rt.RuntimeConfig(**cfg), clock=ref_rt.SimClock())
    port = rt_mod.ServeRuntime(pool, rt_mod.RuntimeConfig(**cfg), clock=rt_mod.SimClock())
    return ref, port


def _record_waves(runtime) -> list:
    """Every served wave as (bucket, padded batch, rids, reason)."""
    waves = []
    runtime.add_wave_observer(lambda res: waves.append((
        res.wave.bucket, res.wave.batch_size,
        tuple(r.rid for r in res.wave.requests), res.wave.reason,
    )))
    return waves


def _oracle(image: np.ndarray) -> np.ndarray:
    ws = cs.init_weights(SPEC, seed=5)
    return cs.run_direct(SPEC, ws, torch.from_numpy(image)[None])[0].numpy()


# ------------------------------------------------------------ load generation

TRACES = {
    "poisson-sizes-priorities": dict(rate_hz=100.0, n=20, seed=3, sizes=(12, 16),
                                     priorities=(0, 1)),
    "poisson-serve-runtime-bench": dict(rate_hz=40.0, n=120, seed=7, sizes=(32, 48, 64)),
    "poisson-deadline": dict(rate_hz=500.0, n=30, seed=11, sizes=(16,), deadline_s=0.02),
}


def _rows(trace):
    return [dataclasses.astuple(a) for a in trace]


@pytest.mark.parametrize("name", sorted(TRACES))
def test_poisson_trace_matches_reference(name):
    kw = dict(TRACES[name])
    rate, n = kw.pop("rate_hz"), kw.pop("n")
    got = rt_mod.poisson_trace(rate, n, **kw)
    assert _rows(got) == _rows(ref_rt.poisson_trace(rate, n, **kw))
    assert [a.t for a in got] == sorted(a.t for a in got)


def test_burst_trace_matches_reference():
    kw = dict(burst=5, period_s=0.25, seed=4, sizes=(16, 32), priorities=(0, 1, 2))
    assert _rows(rt_mod.burst_trace(23, **kw)) == _rows(ref_rt.burst_trace(23, **kw))


def test_diurnal_rate_and_trace_match_reference():
    kw = dict(depth=0.6, period_s=10.0, phase_s=1.5)
    rate, ref_rate = rt_mod.diurnal_rate(20.0, **kw), ref_rt.diurnal_rate(20.0, **kw)
    assert [rate(t) for t in np.linspace(0, 20, 41)] == [ref_rate(t) for t in np.linspace(0, 20, 41)]
    got = rt_mod.diurnal_trace(20.0, 40, seed=9, sizes=(16, 32), **kw)
    assert _rows(got) == _rows(ref_rt.diurnal_trace(20.0, 40, seed=9, sizes=(16, 32), **kw))
    with pytest.raises(ValueError, match="depth"):
        rt_mod.diurnal_rate(1.0, depth=1.0)


def test_merge_traces_and_images_match_reference():
    a = rt_mod.poisson_trace(50.0, 10, seed=1, sizes=(16,))
    b = rt_mod.burst_trace(6, burst=3, period_s=0.1, seed=2, sizes=(12,))
    ra = ref_rt.poisson_trace(50.0, 10, seed=1, sizes=(16,))
    rb = ref_rt.burst_trace(6, burst=3, period_s=0.1, seed=2, sizes=(12,))
    merged = rt_mod.merge_traces(a, b)
    assert _rows(merged) == _rows(ref_rt.merge_traces(ra, rb))
    assert [m.rid for m in merged] == list(range(16))
    imgs, ref_imgs = rt_mod.make_images(merged, 4, seed=12), ref_rt.make_images(merged, 4, seed=12)
    assert imgs.keys() == ref_imgs.keys()
    assert all(np.array_equal(imgs[k], ref_imgs[k]) for k in imgs)


# ---------------------------------------------------------------- telemetry

SAMPLES = {
    "uniform-1-100ms": [ms * 1e-3 for ms in range(1, 101)],
    "lognormal-seed0": list(np.random.default_rng(0).lognormal(-5.0, 1.5, 500)),
    "under-and-overflow": [1e-8, 5e-7, 2e-3, 2e3, 7.5],
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_percentiles_equal_reference(name):
    h, ref = rt_mod.Histogram(), ref_rt.Histogram()
    for v in SAMPLES[name]:
        h.record(v)
        ref.record(v)
    for p in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.percentile(p) == ref.percentile(p)
    assert h.snapshot() == ref.snapshot()


def test_telemetry_snapshot_and_stamp_match_reference():
    docs = []
    for mod in (rt_mod, ref_rt):
        clock = mod.SimClock()
        t = mod.Telemetry(clock=clock)
        assert t.stamp() == {"seq": 0, "t": None}
        t.inc("waves")
        clock.advance(0.5)
        t.observe("queue_wait", 0.01)
        t.set_gauge("queue_depth", 3)
        assert t.stamp() == {"seq": 3, "t": 0.5}
        docs.append(t.snapshot(cache={"hits": 1}, stages=None))
    json.dumps(docs[0])
    assert docs[0] == docs[1]
    assert "stages" not in docs[0] and docs[0]["meta"]["seq"] == 3
    assert rt_mod.stage_rollup([("s0", 1e-3)]) == ref_rt.stage_rollup([("s0", 1e-3)])


# ---------------------------------------------------- waves under a SimClock


def test_deadline_flush_partial_wave_matches_reference():
    """A wave flushed by the oldest request's expired slack: the same
    decision at the same simulated instant in both packages, outputs
    equal to the same requests served alone (bitwise, direct plan) and
    to the reference's."""
    cfg = dict(max_batch=8, buckets=(16,), slo_s=0.05)
    ref, port = _pair(cfg, allowed=("direct",))
    waves, ref_waves = _record_waves(port), _record_waves(ref)
    rng = np.random.default_rng(0)
    imgs = {0: _image(rng, 16), 1: _image(rng, 12), 2: _image(rng, 16)}
    for rid, im in imgs.items():
        assert port.submit(im, rid=rid) is None and ref.submit(im, rid=rid) is None
    for r in (port, ref):
        r.clock.advance(0.049)
    assert port.poll() == ref.poll() == 0
    for r in (port, ref):
        r.clock.advance(0.002)
    assert port.poll() == ref.poll() == 1
    assert waves == ref_waves == [(16, 4, (0, 1, 2), rt_mod.FLUSH_DEADLINE)]
    assert port.scheduler.stats() == ref.scheduler.stats()
    assert port.telemetry.snapshot()["counters"] == ref.telemetry.snapshot()["counters"]
    _, alone = _pair(cfg, allowed=("direct",))
    for rid, im in imgs.items():
        alone.submit(im, rid=rid)
        alone.drain()
        assert np.array_equal(port.results[rid], alone.results[rid]), rid
        assert _rel(port.results[rid], ref.results[rid]) < SERVE_TOL
        assert _rel(port.results[rid], _oracle(im)) < ORACLE_TOL


def test_full_wave_dispatches_without_waiting():
    ref, port = _pair(dict(max_batch=2, buckets=(16,), slo_s=10.0))
    rng = np.random.default_rng(1)
    a, b = _image(rng, 16), _image(rng, 16)
    for r in (port, ref):
        r.submit(a, rid=0)
    assert port.poll() == ref.poll() == 0  # half a wave, plenty of slack
    for r in (port, ref):
        r.submit(b, rid=1)
    assert port.poll() == ref.poll() == 1  # full wave: immediate
    assert port.scheduler.partial_waves == ref.scheduler.partial_waves == 0
    assert set(port.results) == set(ref.results) == {0, 1}


def _sched_pair(cfg: dict):
    return (rt_mod.WaveScheduler(SPEC, rt_mod.RuntimeConfig(**cfg)),
            ref_rt.WaveScheduler(REF_SPEC, ref_rt.RuntimeConfig(**cfg)))


def test_priority_classes_pop_before_fifo():
    rng = np.random.default_rng(2)
    imgs = [_image(rng, 16) for _ in range(4)]
    out = []
    for sched, mod in zip(_sched_pair(dict(max_batch=2, buckets=(16,), queue_depth=8)),
                          (rt_mod, ref_rt)):
        for rid in (1, 2, 3):
            assert sched.admit(mod.Request(rid=rid, image=imgs[rid], priority=mod.STANDARD),
                               now=float(rid)) is None
        assert sched.admit(mod.Request(rid=9, image=imgs[0], priority=mod.INTERACTIVE),
                           now=4.0) is None
        out.append([[r.rid for r in sched.next_wave(now=4.0).requests] for _ in range(2)])
    assert out[0] == out[1] == [[9, 1], [2, 3]]


def test_interactive_slo_tighter_than_batch():
    rng = np.random.default_rng(3)
    a, b = _image(rng, 16), _image(rng, 16)
    got = []
    for mod, spec in ((rt_mod, SPEC), (ref_rt, REF_SPEC)):
        cfg = mod.RuntimeConfig(max_batch=8, buckets=(16,),
                                slo_s={mod.INTERACTIVE: 0.01, mod.STANDARD: 1.0})
        sched = mod.WaveScheduler(spec, cfg)
        sched.admit(mod.Request(rid=0, image=a, priority=mod.STANDARD), now=0.0)
        assert sched.next_wave(0.5) is None
        sched.admit(mod.Request(rid=1, image=b, priority=mod.INTERACTIVE), now=0.5)
        w = sched.next_wave(0.52)
        got.append((w.reason, [r.rid for r in w.requests]))
    assert got[0] == got[1] == ("deadline", [1, 0])


def test_round_robin_alternates_ready_buckets():
    rng = np.random.default_rng(4)
    imgs = [_image(rng, 16 if rid % 2 == 0 else 32) for rid in range(12)]
    seqs = []
    for sched, mod in zip(_sched_pair(dict(max_batch=2, buckets=(16, 32), queue_depth=64)),
                          (rt_mod, ref_rt)):
        for rid, im in enumerate(imgs):
            assert sched.admit(mod.Request(rid=rid, image=im), now=0.0) is None
        seq = []
        while (w := sched.next_wave(0.0)) is not None:
            seq.append((w.bucket, [r.rid for r in w.requests]))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert [b for b, _ in seqs[0]] == [32, 16, 32, 16, 32, 16]


def test_admission_rejects_with_reasons():
    ref, port = _pair(dict(max_batch=8, buckets=(16,), queue_depth=2))
    rng = np.random.default_rng(5)
    reqs = [_image(rng, 16), _image(rng, 16), _image(rng, 16), _image(rng, 32),
            rng.standard_normal((16, 16, 5)).astype(np.float32)]
    for rid, im in enumerate(reqs):
        got, want = port.submit(im, rid=rid), ref.submit(im, rid=rid)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.reason == want.reason
    assert {k: v.reason for k, v in port.rejections.items()} == {
        2: rt_mod.REJECT_QUEUE_FULL, 3: rt_mod.REJECT_TOO_LARGE, 4: rt_mod.REJECT_BAD_SHAPE}
    assert port.scheduler.stats()["rejected"] == ref.scheduler.stats()["rejected"]
    assert port.telemetry.snapshot()["counters"] == ref.telemetry.snapshot()["counters"]
    for r in (port, ref):
        r.drain()
    assert set(port.results) == set(ref.results) == {0, 1}


@pytest.mark.parametrize("pad_batch", [True, False])
def test_partial_wave_hysteresis_matches_reference(pad_batch):
    """A deadline-flushed single request rides the batch the bucket
    already served (padded to a power of two) -- one program in both
    packages; without hysteresis both count a second one."""
    ref, port = _pair(dict(max_batch=4, buckets=(16,), slo_s=0.05, pad_batch=pad_batch),
                      allowed=("direct",))
    waves, ref_waves = _record_waves(port), _record_waves(ref)
    rng = np.random.default_rng(6)
    imgs = [_image(rng, 16) for _ in range(4)]
    for rid in range(3):
        for r in (port, ref):
            r.submit(imgs[rid], rid=rid)
    for r in (port, ref):
        r.clock.advance(0.06)
    assert port.poll() == ref.poll() == 1
    for r in (port, ref):
        r.submit(imgs[3], rid=7)
        r.clock.advance(0.06)
    assert port.poll() == ref.poll() == 1
    assert waves == ref_waves
    assert [w[1] for w in waves] == ([4, 4] if pad_batch else [3, 1])
    programs = port.pool.stats()["compiled_programs"]
    assert programs == ref.pool.stats()["compiled_programs"] == (1 if pad_batch else 2)


def test_replica_pool_shares_cache_and_balances():
    ref, port = _pair(dict(max_batch=1, buckets=(16,)), n=2)
    rng = np.random.default_rng(7)
    imgs = {rid: _image(rng, 16) for rid in range(4)}
    for rid, im in imgs.items():
        for r in (port, ref):
            r.submit(im, rid=rid)
            r.poll()  # max_batch=1: every request is a full wave
    stats, ref_stats = port.pool.stats(), ref.pool.stats()
    assert stats["dispatched"] == ref_stats["dispatched"] == [2, 2]
    assert stats["in_flight"] == [0, 0]
    # transforms prepared once for the whole pool, reused by the peer
    cache, ref_cache = port.pool.cache.stats(), ref.pool.cache.stats()
    assert (cache["misses"], cache["hits"]) == (ref_cache["misses"], ref_cache["hits"])
    for rid, im in imgs.items():
        assert _rel(port.results[rid], ref.results[rid]) < SERVE_TOL
        assert _rel(port.results[rid], _oracle(im)) < ORACLE_TOL


def test_replica_pool_rejects_split_caches():
    ws = cs.init_weights(SPEC, seed=5)
    hw = analysis.HardwareModel(**_BIG)
    a = cs.Engine(hw=hw, device="cpu").compile(SPEC, ws, input_hw=(16, 16))
    b = cs.Engine(hw=hw, device="cpu").compile(SPEC, ws, input_hw=(16, 16))
    with pytest.raises(ValueError, match="share one KernelCache"):
        rt_mod.ReplicaPool([a, b], workers=0)
    pool = rt_mod.ReplicaPool([a], workers=0)
    with pytest.raises(ValueError, match="share the pool's KernelCache"):
        pool.swap([b])


def test_replica_pool_swap_returns_the_old_executors():
    ws = cs.init_weights(SPEC, seed=5)
    engine = cs.Engine(hw=analysis.HardwareModel(**_BIG), device="cpu")
    pool = rt_mod.ReplicaPool.build(engine, SPEC, ws, n=2, workers=0, input_hw=(16, 16))
    new = [engine.compile(SPEC, ws, plan=pool.executors[0].plan) for _ in range(2)]
    old = pool.swap(new)
    assert len(old) == 2 and pool.executors == new
    with pytest.raises(ValueError, match="swap needs 2"):
        pool.swap(new[:1])


def test_poisson_trace_end_to_end_matches_reference():
    """A seeded trace replayed under a SimClock: the same waves, the same
    counters, the same telemetry keys and histogram counts; outputs
    within SERVE_TOL of the reference's."""
    cfg = dict(max_batch=4, buckets=(16,), slo_s=0.05, queue_depth=32)
    ref, port = _pair(cfg)
    waves, ref_waves = _record_waves(port), _record_waves(ref)
    trace = rt_mod.poisson_trace(200.0, 12, seed=11, sizes=(12, 16))
    images = rt_mod.make_images(trace, 4, seed=12)
    results = port.play(trace, images)
    ref_results = ref.play(ref_rt.poisson_trace(200.0, 12, seed=11, sizes=(12, 16)),
                           ref_rt.make_images(trace, 4, seed=12))
    assert waves == ref_waves and len(waves) >= 3
    assert set(results) == set(ref_results) == {a.rid for a in trace}
    doc, ref_doc = port.stats(profile_bucket=16), ref.stats(profile_bucket=16)
    json.dumps(doc)
    assert set(doc) == set(ref_doc)
    assert doc["counters"] == ref_doc["counters"]
    assert doc["scheduler"] == ref_doc["scheduler"]
    assert set(doc["latency"]) == set(ref_doc["latency"])
    for name, h in doc["latency"].items():
        assert h["count"] == ref_doc["latency"][name]["count"], name
    # simulated-time histograms do not depend on the host: equal
    for name in ("queue_wait", "e2e"):
        assert doc["latency"][name] == ref_doc["latency"][name], name
    assert doc["latency"]["queue_wait"]["max_s"] <= 0.05 + 1e-9
    assert [s["label"] for s in doc["stages"]] == [s["label"] for s in ref_doc["stages"]]
    assert doc["pool"]["dispatched"] == ref_doc["pool"]["dispatched"]
    for a in trace:
        assert _rel(results[a.rid], ref_results[a.rid]) < SERVE_TOL
        assert _rel(results[a.rid], _oracle(images[a.rid])) < ORACLE_TOL


def test_roofline_section_rows_match_reference():
    """`stats(profile_bucket=)`'s roofline section names the same stages
    with the same FLOP/byte terms, levels and keys (the backend part of
    the key is each package's own)."""
    ref, port = _pair(dict(max_batch=2, buckets=(16,)))
    rng = np.random.default_rng(8)
    for r in (port, ref):
        r.submit(_image(rng, 16), rid=0)
        r.drain()
    sec, ref_sec = (r.stats(profile_bucket=16)["roofline"] for r in (port, ref))
    assert sec["schema_version"] == ref_sec["schema_version"] == 2
    assert sec["hw"] == ref_sec["hw"]
    assert len(sec["stages"]) == len(ref_sec["stages"]) > 0
    for row, want in zip(sec["stages"], ref_sec["stages"]):
        for key in ("stage", "fused", "flops", "dram_bytes", "ai_dram", "ai_fast",
                    "predicted_us"):
            assert row[key] == want[key], key
        assert row["key"].split(":", 1)[1] == want["key"].split(":", 1)[1]
        assert row["key"].startswith("torch-cpu:")


def test_threaded_pool_serves_what_the_inline_pool_serves():
    """Two worker threads on a real clock give, request for request, the
    outputs the inline pool gives (the CPU path; on the card each worker
    runs its own stream, `tests/test_torch_kernel_cuda.py`)."""
    ws = cs.init_weights(SPEC, seed=5)
    engine = cs.Engine(hw=analysis.HardwareModel(**_BIG), device="cpu")
    inline = rt_mod.ReplicaPool.build(engine, SPEC, ws, n=2, workers=0, input_hw=(16, 16))
    threaded = rt_mod.ReplicaPool.build(engine, SPEC, ws, n=2, input_hw=(16, 16))
    assert threaded.workers == 2 and threaded.cache is inline.cache
    threaded.warmup((16,), (4,))
    trace = rt_mod.poisson_trace(400.0, 16, seed=3, sizes=(12, 16))
    images = rt_mod.make_images(trace, 4, seed=4)
    cfg = rt_mod.RuntimeConfig(max_batch=4, buckets=(16,), slo_s=0.01)
    a = rt_mod.ServeRuntime(inline, cfg, clock=rt_mod.SimClock()).play(trace, images)
    service = rt_mod.ServeRuntime(threaded, cfg)
    b = service.play(trace, images)
    service.shutdown()
    assert set(a) == set(b) == {t.rid for t in trace}
    assert not service.errors
    for rid in a:
        assert _rel(b[rid], a[rid]) < SERVE_TOL
    assert sum(threaded.stats()["dispatched"]) == service.telemetry.counter("waves")


def test_wave_error_is_counted_and_serving_continues():
    """An executor failure surfaces as `wave_errors` and in `errors`, as
    in the reference; the runtime keeps serving later waves."""
    _, port = _pair(dict(max_batch=1, buckets=(16,)))
    rng = np.random.default_rng(9)
    real = port.pool.executors[0]

    class Broken:
        spec, cache, compile_count = real.spec, real.cache, 0

        def __call__(self, x, sizes=None):
            raise RuntimeError("boom")

    port.pool.executors[0] = Broken()
    port.submit(_image(rng, 16), rid=0)
    port.poll()
    port.pool.executors[0] = real
    port.submit(_image(rng, 16), rid=1)
    port.drain()
    assert port.telemetry.counter("wave_errors") == 1 and len(port.errors) == 1
    assert set(port.results) == {1}
