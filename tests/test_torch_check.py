"""The port's static verification (`repro_torch.convserve.check`) against
the reference's (`repro.convserve.check`), on the CPU.

The same plans give the same CVK code sets from both IR verifiers: the
five benched configs verify clean (under the tests' large model, the
H100 and the paper's SkylakeX), and each seeded mutation fails with its
documented code in both.  The same fixture snippets give the same codes
from both lock analyzers and both rule linters, except CVK320, which the
port restates for CUDA and Triton launches and tests on snippets of its
own.  Then the integration points, as the reference's tests hold them:
`Engine.compile(verify=)`, `hot_swap`'s gate, the adapt loop's
reason-coded rejection, the injected clock, and the CLI `--strict`-clean
on the committed port tree.
"""

import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.configs import convnets as ref_convnets
from repro.convserve import AdaptConfig as RefAdaptConfig
from repro.convserve import AdaptController as RefAdaptController
from repro.convserve import Engine as RefEngine
from repro.convserve import init_weights as ref_init_weights
from repro.convserve import planner as ref_planner
from repro.convserve.check.ir import verify_program as ref_verify_program
from repro.convserve.check.locks import analyze_locks as ref_analyze_locks
from repro.convserve.check.rules import DEFAULT_RULES as REF_DEFAULT_RULES
from repro.convserve.check.rules import analyze_rules as ref_analyze_rules
from repro.convserve.graph import NetSpec as RefNetSpec
from repro.convserve.graph import conv as ref_conv
from repro.convserve.graph import maxpool as ref_maxpool
from repro.convserve.graph import relu as ref_relu
from repro.convserve.plan import FusionGroup as RefFusionGroup
from repro.convserve.program import lower as ref_lower
from repro.convserve import runtime as ref_rt
from repro.core import analysis as ref_analysis
from repro.core import registry as ref_registry
from repro_torch.configs import convnets
from repro_torch.convserve import (
    AdaptConfig,
    AdaptController,
    Engine,
    hot_swap,
    init_weights,
    planner,
)
from repro_torch.convserve.check.__main__ import BENCHED_CONFIGS, main as check_main
from repro_torch.convserve.check.diagnostics import (
    HINTS,
    CheckReport,
    Diagnostic,
    ProgramError,
    VerificationError,
    program_error,
)
from repro_torch.convserve.check.ir import verify_compiled, verify_program
from repro_torch.convserve.check.locks import analyze_locks
from repro_torch.convserve.check.rules import DEFAULT_RULES, analyze_rules
from repro_torch.convserve.graph import NetSpec, conv, maxpool, relu
from repro_torch.convserve.plan import FusionGroup
from repro_torch.convserve.planner import plan_net
from repro_torch.convserve.program import lower
from repro_torch.convserve.runtime import ReplicaPool, RuntimeConfig, ServeRuntime, SimClock
from repro_torch.core import analysis, registry

_BIG = dict(
    name="big", peak_flops=1e12, dram_bw=1e11, fast_shared_bw=5e11,
    fast_shared_bytes=1 << 30, private_bytes=1 << 24,
)
BIG_HW, REF_BIG_HW = analysis.HardwareModel(**_BIG), ref_analysis.HardwareModel(**_BIG)
SPEC, REF_SPEC = convnets.tiny_testnet(4), ref_convnets.tiny_testnet(4)


@pytest.fixture(autouse=True)
def _no_wisdom(tmp_path, monkeypatch):
    """Both packages plan from the model alone: an empty wisdom file."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def _groups(plan):
    return [dataclasses.astuple(g) for g in plan.groups]


def _codes(report):
    return sorted(d.code for d in report.diagnostics)


def _hw_pair(name):
    """(port, reference) hardware models of one name: the tests' large
    model, and the port's H100 and SkylakeX posed to both planners."""
    hw = {"big": BIG_HW, "h100": analysis.H100_SXM, "skylake": analysis.SKYLAKE_X}[name]
    return hw, ref_analysis.HardwareModel(**dataclasses.asdict(hw))


@pytest.fixture(scope="module")
def plans():
    """(port, reference) plans of tiny_testnet at 64x64 under BIG."""
    return plan_net(SPEC, 64, 64, hw=BIG_HW), ref_planner.plan_net(REF_SPEC, 64, 64, hw=REF_BIG_HW)


# ------------------------------------------------- diagnostics core


def test_diagnostic_format_and_hint_autofill():
    d = Diagnostic(code="CVK111", message="slab too big", loc="net/fuse")
    assert d.severity == "error" and d.hint == HINTS["CVK111"]
    s = d.format()
    assert "CVK111" in s and "net/fuse" in s and "slab too big" in s
    rep = CheckReport(analyzer="ir")
    assert rep.ok and not rep.errors
    rep.add(d)
    assert not rep.ok and rep.has("CVK111") and list(rep.codes()) == ["CVK111"]
    doc = rep.to_dict()
    assert doc["analyzer"] == "ir" and len(doc["diagnostics"]) == 1
    json.loads(rep.to_json())
    # every code the reference knows, the port knows
    from repro.convserve.check.diagnostics import HINTS as REF_HINTS

    assert set(HINTS) == set(REF_HINTS)


def test_program_error_is_plain_valueerror():
    e = program_error("CVK101", "plan is for net 'a', spec is 'b'")
    assert isinstance(e, ProgramError) and isinstance(e, ValueError)
    assert str(e) == "plan is for net 'a', spec is 'b'"
    assert e.code == "CVK101" and e.diagnostic.code == "CVK101"


def test_verification_error_carries_codes():
    rep = CheckReport(analyzer="ir")
    rep.add(Diagnostic(code="CVK105", message="dtype break", loc="x"))
    err = VerificationError(rep)
    assert list(err.codes) == ["CVK105"] and "CVK105" in str(err)


# ------------------------------------------- IR: clean on benched configs


@pytest.mark.parametrize("hw_name", ("big", "h100", "skylake"))
@pytest.mark.parametrize("name", BENCHED_CONFIGS)
def test_benched_configs_verify_clean_in_both(name, hw_name):
    hw, ref_hw = _hw_pair(hw_name)
    spec, ref_spec = getattr(convnets, name)(), getattr(ref_convnets, name)()
    plan = plan_net(spec, 64, 64, hw=hw)
    ref_plan = ref_planner.plan_net(ref_spec, 64, 64, hw=ref_hw)
    assert plan.algos() == ref_plan.algos() and _groups(plan) == _groups(ref_plan)
    rep = verify_program(spec, plan, hw=hw)
    assert rep.ok, f"{name}: {rep.format()}"
    assert _codes(rep) == _codes(ref_verify_program(ref_spec, ref_plan, hw=ref_hw))


# --------------------------------------------- IR: seeded plan mutations
# Each mutation corrupts one invariant of the same plan in both packages
# and must surface the documented code, the same code set in both.


def _tile_rows(plan, spec, _):
    g0 = plan.groups[0]
    return spec, dataclasses.replace(
        plan, groups=(dataclasses.replace(g0, tile_rows=10_000_000),) + plan.groups[1:]
    ), None


def _dtype(plan, spec, _):
    l0 = plan.layers[0]
    l0 = dataclasses.replace(l0, spec=dataclasses.replace(l0.spec, dtype="bfloat16"))
    return spec, dataclasses.replace(plan, layers=(l0,) + plan.layers[1:]), None


def _dropped_param(plan, spec, reg):
    idx, dropped = next(
        (i, reg.get(p.algo).weight_params[0])
        for i, p in enumerate(plan.layers)
        if reg.get(p.algo).consumes_wt and reg.get(p.algo).weight_params
    )
    p = plan.layers[idx]
    p = dataclasses.replace(p, params={k: v for k, v in p.params.items() if k != dropped})
    return spec, dataclasses.replace(
        plan, layers=plan.layers[:idx] + (p,) + plan.layers[idx + 1:]
    ), None


def _renamed(plan, spec, _):
    return spec, dataclasses.replace(plan, net="somebody-else"), None


def _input_hw(plan, spec, _):
    return spec, dataclasses.replace(plan, input_hw=(63, 63)), None


def _duplicate_units(plan, spec, lower_fn):
    prog = lower_fn(spec, plan)
    return spec, plan, dataclasses.replace(
        prog, stages=(prog.stages[0], prog.stages[0]) + prog.stages[1:]
    )


def _phantom_rows(plan, spec, lower_fn):
    prog = lower_fn(spec, plan)
    fi = next(i for i, st in enumerate(prog.stages) if st.fused)
    st = prog.stages[fi]
    u0 = st.units[0]
    shrunk = dataclasses.replace(u0, plan=dataclasses.replace(
        u0.plan, spec=dataclasses.replace(u0.plan.spec, h=2)))
    bad_stage = dataclasses.replace(st, units=(shrunk,) + st.units[1:])
    return spec, plan, dataclasses.replace(
        prog, stages=prog.stages[:fi] + (bad_stage,) + prog.stages[fi + 1:]
    )


# name -> (mutation, the aux argument per package, expected code(s))
MUTATIONS = {
    "oversized-tile-rows": (_tile_rows, None, {"CVK111"}),
    "dtype-break": (_dtype, None, {"CVK105"}),
    "dropped-weight-param": (_dropped_param, "registry", {"CVK114"}),
    "renamed-net": (_renamed, None, {"CVK101"}),
    "wrong-input-hw": (_input_hw, None, {"CVK116", "CVK113"}),
    "duplicate-units-collide": (_duplicate_units, "lower", {"CVK114"}),
    "phantom-rows": (_phantom_rows, "lower", {"CVK116"}),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_gives_the_same_codes_in_both(plans, name):
    mutate, aux, want = MUTATIONS[name]
    plan, ref_plan = plans
    assert plan.algos() == ref_plan.algos() and plan.groups, "seed plan must be fused"
    assert _groups(plan) == _groups(ref_plan)
    port_aux = {"registry": registry, "lower": lower}.get(aux)
    ref_aux = {"registry": ref_registry, "lower": ref_lower}.get(aux)
    spec, bad, prog = mutate(plan, SPEC, port_aux)
    ref_spec, ref_bad, ref_prog = mutate(ref_plan, REF_SPEC, ref_aux)
    rep = verify_program(spec, bad, program=prog, hw=BIG_HW)
    ref_rep = ref_verify_program(ref_spec, ref_bad, program=ref_prog, hw=REF_BIG_HW)
    assert rep.errors and set(_codes(rep)) & want, rep.format()
    assert _codes(rep) == _codes(ref_rep)


def test_mutation_pool_mid_group_is_cvk110_in_both():
    layers = lambda c, r, m: (c(4, 8), r(), m(2), c(8, 8), r())  # noqa: E731
    spec = NetSpec(name="pool-mid", layers=layers(conv, relu, maxpool))
    ref_spec = RefNetSpec(name="pool-mid", layers=layers(ref_conv, ref_relu, ref_maxpool))
    bad = dataclasses.replace(plan_net(spec, 16, 16, hw=BIG_HW),
                              groups=(FusionGroup(layers=(0, 3)),))
    ref_bad = dataclasses.replace(ref_planner.plan_net(ref_spec, 16, 16, hw=REF_BIG_HW),
                                  groups=(RefFusionGroup(layers=(0, 3)),))
    rep = verify_program(spec, bad, hw=BIG_HW)
    assert rep.has("CVK110"), rep.format()
    assert _codes(rep) == _codes(ref_verify_program(ref_spec, ref_bad, hw=REF_BIG_HW))


# ------------------------------------------------ Engine.compile(verify=)


@pytest.fixture(scope="module")
def weights():
    return init_weights(SPEC, seed=5)


def _corrupt(plan):
    return _tile_rows(plan, None, None)[1]


def test_compile_strict_rejects_corrupt_plan(plans, weights):
    with pytest.raises(VerificationError) as ei:
        Engine(hw=BIG_HW, device="cpu").compile(
            SPEC, weights, plan=_corrupt(plans[0]), fuse=None)
    assert "CVK111" in ei.value.codes


def test_compile_verify_off_and_warn_still_compile(plans, weights, capsys):
    engine = Engine(hw=BIG_HW, device="cpu")
    bad = _corrupt(plans[0])
    net = engine.compile(SPEC, weights, plan=bad, fuse=None, verify="off")
    assert net.report is None
    net = engine.compile(SPEC, weights, plan=bad, fuse=None, verify="warn")
    assert net.report is not None and net.report.has("CVK111")
    assert "CVK111" in capsys.readouterr().out


def test_compile_strict_clean_plan_attaches_report(weights):
    net = Engine(hw=BIG_HW, device="cpu").compile(SPEC, weights, input_hw=(16, 16))
    assert net.report is not None and net.report.ok
    assert net.hw is BIG_HW and verify_compiled(net).ok


def test_compile_rejects_unknown_verify_mode(weights):
    with pytest.raises(ValueError, match="verify"):
        Engine(hw=BIG_HW, device="cpu").compile(
            SPEC, weights, input_hw=(16, 16), verify="sometimes")


# --------------------------------------------------- hot_swap's gate


def test_hot_swap_refuses_verification_failing_candidate(weights):
    engine = Engine(hw=BIG_HW, device="cpu")
    pool = ReplicaPool.build(engine, SPEC, weights, n=1, workers=0, input_hw=(16, 16))
    live = pool.executors[0]
    cand = engine.compile(SPEC, weights, plan=_corrupt(live.plan), fuse=None, verify="off")
    with pytest.raises(VerificationError) as ei:
        hot_swap(pool, [cand])
    assert "CVK111" in ei.value.codes
    assert pool.executors[0] is live  # dispatch never flipped
    old = hot_swap(pool, [cand], verify=False)
    assert old == [live]
    hot_swap(pool, old, verify=False)  # rollback


# ------------------------------------- adapt: reason-coded rejection


def _corrupting(real_plan_net):
    def plan_net_(*a, **kw):
        plan = real_plan_net(*a, **kw)
        l0 = plan.layers[0]
        l0 = dataclasses.replace(l0, spec=dataclasses.replace(l0.spec, dtype="bfloat16"))
        return dataclasses.replace(plan, layers=(l0,) + plan.layers[1:])

    return plan_net_


def _rejecting_loop(pkg):
    """One package's adapt loop over tiny_testnet on inline replicas and
    a SimClock, with a probe that measures fused stages at 10x their
    prediction: (controller, runtime, planner module)."""
    if pkg == "port":
        engine = Engine(hw=BIG_HW, device="cpu")
        ws = init_weights(SPEC, seed=5)
        pool = ReplicaPool.build(engine, SPEC, ws, n=1, workers=0, input_hw=(16, 16))
        rt = ServeRuntime(pool, RuntimeConfig(max_batch=2, buckets=(16,), slo_s=1.0,
                                              service_est_s=1e-4), clock=SimClock())
        plan_mod, ctl, cfg, spec = planner, AdaptController, AdaptConfig, SPEC
    else:
        engine = RefEngine(hw=REF_BIG_HW)
        ws = ref_init_weights(REF_SPEC, seed=5)
        pool = ref_rt.ReplicaPool.build(engine, REF_SPEC, ws, n=1, workers=0,
                                        input_hw=(16, 16))
        rt = ref_rt.ServeRuntime(pool, ref_rt.RuntimeConfig(
            max_batch=2, buckets=(16,), slo_s=1.0, service_est_s=1e-4),
            clock=ref_rt.SimClock())
        plan_mod, ctl, cfg, spec = ref_planner, RefAdaptController, RefAdaptConfig, REF_SPEC

    def probe(net, bucket, batch):
        preds = plan_mod.predict_stage_times(net.program, engine.hw)
        return [(label, pred * (10.0 if stage.fused else 1.0))
                for stage, (label, pred) in zip(net.program.stages, preds)]

    ac = ctl(rt, engine, spec, ws, cfg(divergence_ratio=2.0, shadow_fraction=1.0,
                                       shadow_min_waves=2, cooldown_s=0.5), probe=probe)
    return ac, rt, plan_mod


def test_adapt_rejects_corrupt_candidate_before_shadow(monkeypatch):
    """A replan candidate that fails static verification is reason-coded
    into the audit log and counters, cools the loop down, and never
    compiles or receives shadow traffic -- the same events and codes as
    the reference."""
    events = {}
    for pkg in ("port", "ref"):
        ac, rt, plan_mod = _rejecting_loop(pkg)
        monkeypatch.setattr(plan_mod, "plan_net", _corrupting(plan_mod.plan_net))
        ac.measure()
        ac.probe_alternatives()
        ac.check()
        events[pkg] = ([a["event"] for a in ac.audit], ac.audit[-1].get("codes"))
        assert rt.telemetry.counter("adapt.verify_rejected") == 1
        assert rt.telemetry.counter("adapt.shadows_run") == 0
        assert ac.state == "idle" and ac.candidate is None
        assert ac._cooldown_until > rt.clock.now()
    assert events["port"] == events["ref"]
    assert events["port"][0] == ["replan", "replan_rejected"]
    assert "CVK105" in events["port"][1]


# --------------------------------------------------- clock routing


def test_engine_clock_threads_into_executors(weights):
    clk = SimClock()
    engine = Engine(hw=BIG_HW, clock=clk, device="cpu")
    net = engine.compile(SPEC, weights, input_hw=(16, 16))
    assert net.executor.clock is clk
    pool = ReplicaPool.build(engine, SPEC, weights, n=1, workers=0, input_hw=(16, 16),
                             clock=clk)
    assert pool.clock is clk and pool.executors[0].executor.clock is clk


def test_profile_stages_reads_injected_clock(weights):
    net = Engine(hw=BIG_HW, clock=SimClock(), device="cpu").compile(
        SPEC, weights, input_hw=(16, 16))
    rows = net.profile_stages(np.zeros((1, 16, 16, 4), np.float32))
    assert rows and all(dt == 0.0 for _, dt in rows)  # sim time stood still


# ---------------------------------------------- fixture trees: both analyzers

LOCK_TREES = {
    "mutation-outside-lock": {"box.py": """\
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []  # guarded-by: _lock

            def good(self):
                with self._lock:
                    self.items.append(1)

            def bad(self):
                self.items.append(2)

            def also_bad(self):
                self.items = []
        """},
    "waivers-and-condition-alias": {"waived.py": """\
        import threading

        class Waived:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.n = 0  # guarded-by: _lock

            def _bump_locked(self):
                self.n += 1

            def helper(self):
                # holds-lock: _lock
                self.n += 1

            def via_cv(self):
                with self._cv:
                    self.n += 1
        """},
    "lock-order-cycle": {"cycle.py": """\
        import threading

        class Tangle:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self.x = 0  # guarded-by: _a

            def one(self):
                with self._a:
                    with self._b:
                        self.x = 1

            def two(self):
                with self._b:
                    with self._a:
                        self.x = 2
        """},
    "unannotated-lock-owner": {"naked.py": """\
        import threading

        class Naked:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
        """},
    "unparseable": {"broken.py": "def nope(:\n"},
}

# the codes each tree must give (both analyzers give the same multiset)
LOCK_WANT = {
    "mutation-outside-lock": ["CVK201", "CVK201"],
    "waivers-and-condition-alias": [],
    "lock-order-cycle": ["CVK202"],
    "unannotated-lock-owner": ["CVK203"],
    "unparseable": ["CVK203"],
}

RULE_TREES = {
    "direct-time-reads": {
        "leaky.py": """\
            import time

            def stamp():
                return time.time()

            def measure():
                return time.perf_counter()
            """,
        "fromimp.py": """\
            from time import perf_counter as pc

            def measure():
                return pc()
            """,
        "runtime/clock.py": """\
            import time

            def now():
                return time.perf_counter()
            """,
    },
    "monotonic-and-sleep-inside-convserve": {
        "convserve/waiter.py": """\
            import time

            def wait():
                time.sleep(0.1)
                return time.monotonic()
            """,
        "offline.py": """\
            import time

            def wait():
                time.sleep(0.1)
                return time.monotonic()
            """,
    },
    "supports-before-execute": {"algos.py": """\
        class Algorithm:
            pass

        class Good(Algorithm):
            def supports(self, spec):
                return True

            def execute(self, spec, x, w):
                return x

        class InheritsSupports(Good):
            def execute(self, spec, x, w):
                return x

        class OutOfOrder(Algorithm):
            def execute(self, spec, x, w):
                return x

            def supports(self, spec):
                return True

        class NoSupportsAnywhere(Algorithm):
            def execute(self, spec, x, w):
                return x
        """},
    "wt-to-non-consumer": {"calls.py": """\
        from somewhere import conv2d

        def run(x, w, wt):
            a = conv2d(x, w, algo="direct", wt=wt)      # flagged
            b = conv2d(x, w, algo="l3_fused", wt=wt)    # consumes wt
            c = conv2d(x, w, algo="auto", wt=wt)        # resolver's call
            d = conv2d(x, w, algo="direct", wt=None)    # explicit no-op
            e = conv2d(x, w, algo="l3_fused_pallas", wt=wt)  # flagged
            return a, b, c, d, e
        """},
    "unparseable": {"broken.py": "class (:\n"},
    "telemetry-discipline": {"poke.py": """\
        def bump(telemetry, tracer, pool):
            telemetry._counters["waves"] = 1
            tracer._events.append(None)
            pool._events.append(None)   # a heap, not the tracer's ring
            telemetry.inc("waves")
        """},
}

RULE_WANT = {
    "direct-time-reads": ["CVK301", "CVK302", "CVK302"],
    "monotonic-and-sleep-inside-convserve": ["CVK303", "CVK303"],
    "supports-before-execute": ["CVK310", "CVK310"],
    "wt-to-non-consumer": ["CVK311", "CVK311"],
    "unparseable": ["CVK304"],
    "telemetry-discipline": ["CVK330", "CVK330"],
}


def _tree(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tmp_path


def _located(report, root):
    """(code, severity, file relative to the tree, or the loc itself when
    it names no file -- a lock cycle's) per diagnostic, sorted."""
    def where(loc):
        path = Path(loc.split(":")[0])
        return str(path.relative_to(root)) if path.is_relative_to(root) else loc

    return sorted((d.code, d.severity, where(d.loc)) for d in report.diagnostics)


@pytest.mark.parametrize("name", sorted(LOCK_TREES))
def test_lock_analyzers_agree_on_fixture_tree(tmp_path, name):
    root = _tree(tmp_path, LOCK_TREES[name])
    rep, ref_rep = analyze_locks([root]), ref_analyze_locks([root])
    assert _codes(rep) == LOCK_WANT[name], rep.format()
    assert _located(rep, root) == _located(ref_rep, root)
    assert [d.message for d in rep.diagnostics] == [d.message for d in ref_rep.diagnostics]


@pytest.mark.parametrize("name", sorted(RULE_TREES))
def test_rule_linters_agree_on_fixture_tree(tmp_path, name):
    root = _tree(tmp_path, RULE_TREES[name])
    rep, ref_rep = analyze_rules([root]), ref_analyze_rules([root])
    assert _codes(rep) == RULE_WANT[name], rep.format()
    assert _located(rep, root) == _located(ref_rep, root)


def test_rules_cvk320_flags_cuda_and_triton_launches_outside_kernels(tmp_path):
    root = _tree(tmp_path, {
        "core/rogue.py": """\
            from repro_torch.kernels.fused_tile import kernel

            def launch(x):
                kernel.LIB.launch("fused_tile_launch", x.device, x.data_ptr())
            """,
        "convserve/sneaky.py": """\
            from repro_torch.kernels._build import CudaLibrary
            from repro_torch.kernels.decode_mlp.kernel import LIB as mlp_lib

            HANDLE = CudaLibrary("a.cu", "a", {})

            def launch(x):
                HANDLE.fn("a_launch")(x.data_ptr())
                mlp_lib.launch("decode_mlp_launch", x.device)
                HANDLE.build()  # building is not a launch
            """,
        "models/tri.py": """\
            import triton

            @triton.jit
            def add_kernel(x, n):
                pass

            def run(x):
                add_kernel[(1,)](x, 4)
            """,
        "kernels/fused_tile/kernel.py": """\
            from repro_torch.kernels import _build
            import triton

            LIB = _build.CudaLibrary("k.cu", "k", {})

            @triton.jit
            def k(x):
                pass

            def call(x):
                LIB.launch("k_launch", x.device)
                k[(1,)](x)
            """,
    })
    rep = analyze_rules([root])
    cvk320 = [d for d in rep.errors if d.code == "CVK320"]
    assert sorted(str(Path(d.loc.split(":")[0]).relative_to(root)) for d in cvk320) == [
        "convserve/sneaky.py", "convserve/sneaky.py", "core/rogue.py", "models/tri.py",
    ]
    assert all("wrapper" in d.message for d in cvk320)
    assert {r.code for r in DEFAULT_RULES} == {r.code for r in REF_DEFAULT_RULES}


def test_committed_port_tree_has_clean_lock_discipline():
    import repro_torch.convserve as cs

    root = Path(cs.__file__).parent
    rep = analyze_locks([root / "runtime", root / "adapt", root / "obs", root / "cache.py",
                         root.parent / "kernels" / "_build.py"])
    assert rep.ok, rep.format()


def test_lock_scope_covers_the_fleet_and_the_fault_schedule(monkeypatch):
    """`check`'s lock analyzer reads the fleet and `runtime/fault.py`,
    as the reference's scope does (`repro.convserve.check.__main__`),
    beside the port's own `kernels/_build.py`; both are clean."""
    from repro.convserve.check import __main__ as ref_cli
    from repro_torch.convserve.check import __main__ as cli

    def scope(mod, pkg):
        seen = []
        monkeypatch.setattr(mod, "analyze_locks", lambda paths: seen.extend(paths))
        mod.run_locks(Path("src"))
        monkeypatch.undo()
        return {p.relative_to(Path("src") / pkg).as_posix() for p in seen}

    got, want = scope(cli, "repro_torch"), scope(ref_cli, "repro")
    assert {"convserve/fleet", "runtime/fault.py"} <= got
    assert got == want | {"kernels/_build.py"}
    import repro_torch

    root = Path(repro_torch.__file__).parent
    rep = analyze_locks([root / "convserve" / "fleet", root / "runtime" / "fault.py"])
    assert rep.ok, rep.format()


# ------------------------------------------------------- CLI


def test_cli_strict_is_clean_on_committed_port_tree(tmp_path, capsys):
    """`python -m repro_torch.convserve.check --strict` exits 0 on the
    committed port tree and writes the baseline artifact."""
    baseline = tmp_path / "convcheck.json"
    rc = check_main(["--strict", "--baseline", str(baseline)])
    out = capsys.readouterr().out
    assert rc == 0, out
    doc = json.loads(baseline.read_text())
    assert doc["errors"] == 0 and doc["warnings"] == 0
    assert {r["analyzer"] for r in doc["reports"]} == {"ir", "locks", "rules"}


def test_cli_only_selects_one_analyzer(capsys):
    assert check_main(["--only", "locks"]) == 0
    assert "1 analyzer(s)" in capsys.readouterr().out
