"""Public front-end: compile a net once, serve it everywhere.

    engine = Engine(hw=...)                      # shared kernel cache
    net = engine.compile(spec, weights)          # plan -> lower -> bind
    y = net(batch)                               # CompiledNet is callable
    net(batch, sizes)                            # ragged batches
    net.save_plan("net.plan.json")               # ship the v3 plan

`Engine.compile` owns the whole NetPlan -> ExecProgram lifecycle: it
plans (or takes a pre-planned/loaded `NetPlan`, upgrading v2 files that
carry no fusion groups), lowers to the staged IR, and binds weights and
the engine-wide `KernelCache` into a `CompiledNet`.  The engine runs on
one device: cuda unless the caller passes ``device="cpu"``.  `ConvServer` and
the examples consume `CompiledNet` -- nothing outside this module needs
to construct a `NetExecutor` (or interpret a plan dict) directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import analysis
from repro_torch.core import tune as tune_mod
from repro_torch.core.device import DeviceLike, dtype_name, resolve_device
from repro_torch.convserve.cache import KernelCache
from repro_torch.convserve.check.diagnostics import CheckReport, VerificationError
from repro_torch.convserve.executor import NetExecutor
from repro_torch.convserve.graph import NetSpec
from repro_torch.convserve.plan import NetPlan
from repro_torch.convserve.planner import plan_net, upgrade_plan
from repro_torch.convserve.program import ExecProgram
from repro_torch.convserve.runtime.clock import Clock

VERIFY_MODES = ("strict", "warn", "off")


@dataclasses.dataclass
class CompiledNet:
    """A planned, lowered, weight-bound net ready to serve.

    Callable: ``net(x, sizes=None)`` with NHWC batches.  The staged IR
    is inspectable (`program`, `describe()`), the plan shippable
    (`save_plan`), and the serving counters unified (`stats()`).
    """

    spec: NetSpec
    plan: NetPlan
    program: ExecProgram
    executor: NetExecutor
    # the hardware model the plan was verified against and the verifier's
    # report -- the hot-swap path re-verifies candidates through these
    hw: Optional[analysis.HardwareModel] = None
    report: Optional[CheckReport] = None

    def __call__(self, x, sizes=None):
        return self.executor(x, sizes)

    @property
    def cache(self) -> KernelCache:
        return self.executor.cache

    @property
    def compile_count(self) -> int:
        return self.executor.compile_count

    def describe(self) -> str:
        return self.program.describe()

    def save_plan(self, path) -> None:
        self.plan.save(path)

    def compiles_by_bucket(self) -> Dict[int, int]:
        return self.executor.compiles_by_bucket()

    def profile_stages(self, x, sizes=None) -> List[Tuple[str, float]]:
        return self.executor.profile_stages(x, sizes)

    def stats(self) -> dict:
        return self.executor.stats()

    def cache_keys(self) -> list:
        return self.executor.cache_keys()


class Engine:
    """Compiles nets against one hardware model and one shared kernel
    cache (multiple nets -- or weight sets -- served side by side reuse
    each other's transforms where fingerprints agree).

    `device` defaults to cuda (raising when there is no card); `hw`
    defaults to the device's own model (`tune.default_hw`)."""

    def __init__(
        self,
        *,
        hw: Optional[analysis.HardwareModel] = None,
        cache: Optional[KernelCache] = None,
        dtype=torch.float32,
        clock: Optional[Clock] = None,
        device: DeviceLike = None,
        tracer=None,
    ):
        self.device = resolve_device(device)
        self.hw = hw or tune_mod.default_hw(self.device)
        self.cache = cache if cache is not None else KernelCache()
        self.dtype = dtype
        self.clock = clock  # threaded into every executor (None = real)
        self.tracer = tracer  # likewise (None = NULL_TRACER)
        self.nets_compiled = 0

    def compile(
        self,
        spec: NetSpec,
        weights: Dict[int, torch.Tensor],
        *,
        input_hw: Tuple[int, int] = (64, 64),
        plan: Optional[NetPlan] = None,
        fuse: Optional[bool] = True,
        verify: str = "strict",
        **plan_kwargs,
    ) -> CompiledNet:
        """NetSpec (+ weights) -> CompiledNet.

        Without `plan`, plans at reference `input_hw` on the engine's
        hardware model.  With `plan` (e.g. loaded from a plan file), the
        per-layer decisions are taken as-is; a v2-era plan with no
        fusion groups is upgraded through the same roofline model first.
        Pass ``fuse=False`` to serve strictly layer-by-layer, or
        ``fuse=None`` to take the plan's groups exactly as given -- the
        adapt loop needs this to compile a deliberately-unfused
        candidate without the upgrade path re-deriving groups for it.

        `verify` runs the static IR verifier (`check.ir.verify_program`)
        on the lowered program before any weights bind: ``"strict"``
        (default) raises `VerificationError` on any finding, ``"warn"``
        prints findings and serves anyway, ``"off"`` skips the pass.
        The report rides on the returned net as `CompiledNet.report`.
        """
        if plan is None:
            plan = plan_net(
                spec, input_hw[0], input_hw[1],
                hw=self.hw, dtype=dtype_name(self.dtype),
                fuse=bool(fuse) if fuse is not None else True,
                device=self.device,
                **plan_kwargs,
            )
        elif plan_kwargs:
            raise ValueError(
                f"plan_kwargs {sorted(plan_kwargs)} are planning knobs: "
                "meaningless with an explicit `plan`"
            )
        elif fuse is None:
            pass  # take the plan verbatim, fused or not
        elif fuse:
            plan = upgrade_plan(spec, plan, self.hw)
        else:
            plan = dataclasses.replace(plan, groups=())
        if verify not in VERIFY_MODES:
            raise ValueError(
                f"verify must be one of {VERIFY_MODES}, got {verify!r}"
            )
        report = None
        if verify != "off":
            from repro_torch.convserve.check.ir import verify_program

            report = verify_program(spec, plan, hw=self.hw)
            if report.errors and verify == "strict":
                raise VerificationError(report)
            if report.diagnostics and verify == "warn":
                print(report.format())
        executor = NetExecutor(
            spec, weights, plan, cache=self.cache, dtype=self.dtype,
            clock=self.clock, device=self.device, tracer=self.tracer,
        )
        self.nets_compiled += 1
        return CompiledNet(
            spec=spec, plan=plan, program=executor.program,
            executor=executor, hw=self.hw, report=report,
        )

    def invalidate(self, net: Optional[str] = None) -> None:
        """Drop cached transforms (all, or one net's) after a weight
        update; the churn shows up as `invalidations` in `stats()`."""
        self.cache.invalidate(net)

    def stats(self) -> dict:
        """Engine-level rollup: nets compiled against this engine plus
        the shared kernel-cache counters (hits/misses/evictions/
        invalidations)."""
        return {
            "nets_compiled": self.nets_compiled,
            "cache": self.cache.stats(),
        }
