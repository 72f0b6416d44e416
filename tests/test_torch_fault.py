"""The port's fault module (`repro_torch.runtime.fault`) against the
reference's, on the CPU: the tests of `tests/test_fault.py` that need no
training loop (its loop waits for the port's training step).  The module
is pure Python, so every schedule, alarm and restart count must be equal
to the reference's."""

import pytest

from repro.convserve.runtime import SimClock as RefSimClock
from repro.runtime import fault as ref_fault
from repro_torch.convserve.runtime import SimClock
from repro_torch.runtime import fault

PKGS = {"port": (fault, SimClock), "reference": (ref_fault, RefSimClock)}


def test_vocabulary_matches_reference():
    assert fault.FAULT_KINDS == ref_fault.FAULT_KINDS
    assert (fault.FAULT_CRASH, fault.FAULT_SLOW, fault.FAULT_CACHE_CORRUPT) == (
        ref_fault.FAULT_CRASH, ref_fault.FAULT_SLOW, ref_fault.FAULT_CACHE_CORRUPT)


def _watch(f, times, **kw):
    wd = f.StragglerWatchdog(**kw)
    return [wd.observe(i, s) for i, s in enumerate(times)], wd.alarms


@pytest.mark.parametrize("times", [
    [0.1] * 10 + [1.0],
    [0.1, 0.2, 0.1, 0.9, 0.1, 0.1, 1.5, 0.1, 0.31, 0.29],
    [0.05 * (i % 7 + 1) for i in range(80)] + [5.0],
])
def test_straggler_watchdog(times):
    got, alarms = _watch(fault, times, factor=3.0, min_steps=5)
    assert (got, alarms) == _watch(ref_fault, times, factor=3.0, min_steps=5)
    if times[:11] == [0.1] * 10 + [1.0]:
        assert got[:10] == [None] * 10
        assert got[10] is not None and got[10]["p50"] < 0.2 and len(alarms) == 1


def test_fault_plan_routes_through_injected_clock():
    def drill(f, clock_cls):
        clock = clock_cls()
        plan = f.FaultPlan([
            f.ReplicaFault(t=2.0, kind=f.FAULT_SLOW, replica=1, factor=8.0),
            f.ReplicaFault(t=1.0, kind=f.FAULT_CRASH, replica=0),
            f.ReplicaFault(t=3.0, kind=f.FAULT_CACHE_CORRUPT),
        ], clock=clock)
        log = [(plan.next_t(), plan.pending(), plan.due())]
        clock.advance(2.5)
        ripe = plan.due()
        log.append([r.kind for r in ripe])
        log.append((plan.due(), plan.next_t()))
        clock.advance(10.0)
        log.append([r.kind for r in plan.due()])
        log.append((plan.next_t(), plan.pending(), plan.stats()))
        return log

    got = drill(fault, SimClock)
    assert got == drill(ref_fault, RefSimClock)
    assert got[0] == (1.0, 3, [])
    assert got[1] == [fault.FAULT_CRASH, fault.FAULT_SLOW]
    assert got[2] == ([], 3.0)
    assert got[3] == [fault.FAULT_CACHE_CORRUPT]
    stats = got[4][2]
    assert got[4][:2] == (float("inf"), 0) and stats["pending"] == 0
    assert [f["t"] for f in stats["fired"]] == [1.0, 2.0, 3.0]


def test_fault_plan_without_clock_requires_explicit_now():
    plan = fault.FaultPlan([fault.ReplicaFault(t=1.0, kind=fault.FAULT_CRASH, replica=0)])
    with pytest.raises(ValueError, match="no injected clock"):
        plan.due()
    assert plan.due(now=0.5) == []
    assert len(plan.due(now=1.0)) == 1
    assert plan.stats() == {"pending": 0, "fired": [{"t": 1.0, "kind": "crash", "replica": 0}]}


@pytest.mark.parametrize("kw,match", [
    (dict(kind="meteor"), "unknown fault kind"),
    (dict(kind="crash"), "needs a target replica"),
    (dict(kind="slow"), "needs a target replica"),
])
def test_replica_fault_validates(kw, match):
    for f in (fault, ref_fault):
        with pytest.raises(ValueError, match=match):
            f.ReplicaFault(t=0.0, **kw)


def test_cache_corruption_needs_no_replica():
    got = fault.ReplicaFault(t=0.0, kind=fault.FAULT_CACHE_CORRUPT)
    want = ref_fault.ReplicaFault(t=0.0, kind=ref_fault.FAULT_CACHE_CORRUPT)
    assert (got.t, got.kind, got.replica, got.factor) == (
        want.t, want.kind, want.replica, want.factor)


def test_straggler_watchdog_stamps_alarms_with_injected_clock():
    def drill(f, clock_cls):
        clock = clock_cls()
        wd = f.StragglerWatchdog(factor=3.0, min_steps=5, clock=clock)
        for i in range(6):
            wd.observe(i, 0.1)
        clock.advance(42.0)
        return wd.observe(6, 1.0)

    alarm = drill(fault, SimClock)
    assert alarm == drill(ref_fault, RefSimClock)
    assert alarm is not None and alarm["t"] == 42.0


def _supervise(f, fail_on, total=10, max_restarts=5):
    calls = {"n": 0, "restores": 0}

    def work(step):
        calls["n"] += 1
        if calls["n"] in fail_on:
            raise f.InjectedFailure("boom")
        return step + 5

    def restore():
        calls["restores"] += 1
        return 0

    final = f.run_supervised(work, start_step=0, total_steps=total,
                             restore=restore, max_restarts=max_restarts)
    return final, calls


@pytest.mark.parametrize("fail_on", [(), (2,), (1, 3), (2, 3, 4)])
def test_supervisor_restarts(fail_on):
    got = _supervise(fault, fail_on)
    assert got == _supervise(ref_fault, fail_on)
    assert got[0] >= 10 and got[1]["restores"] == len(fail_on)


def test_supervisor_gives_up_after_max_restarts():
    for f in (fault, ref_fault):
        with pytest.raises(f.InjectedFailure):
            _supervise(f, (1, 2, 3), max_restarts=2)


def test_failure_injector_fires_each_step_once():
    def drill(f):
        inj = f.FailureInjector(fail_at_steps=(2, 4))
        log = []
        for step in (0, 1, 2, 2, 3, 4, 4, 5):
            try:
                inj.check(step)
                log.append((step, None))
            except f.InjectedFailure as e:
                log.append((step, str(e)))
        return log, sorted(inj.fired)

    got = drill(fault)
    assert got == drill(ref_fault)
    assert [s for s, e in got[0] if e] == [2, 4]
