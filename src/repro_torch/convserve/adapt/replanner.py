"""Divergence monitor + background replanner: the adapt control loop.

`AdaptController` sits beside a live `ServeRuntime` and closes the
measure -> diverge -> replan -> shadow -> promote/rollback loop:

* **measure** -- `measure()` profiles the live program's stages (the
  executor's `profile_stages`, which runs each stage once untimed before
  timing it -- on the card with CUDA events -- so measurements are warm
  by construction: a stage's first call at a shape builds its memo
  entries outside the timed region) and folds them into the
  `MeasuredCostStore` next to the roofline's `predict_stage_times`
  prediction for the same stage.  `probe_alternatives()` does the same
  for the plans the replanner might switch TO (the unfused variant of
  the live plan, the direct baseline), because a measured override can
  only choose between measured options.

* **diverge** -- `check()` compares each live stage's measured/predicted
  ratio against the store-wide median ratio (`ratio_scale`).  A
  uniformly mis-calibrated hardware constant cancels out; one stage
  whose ratio stands `divergence_ratio`x above the rest is a real
  misprediction, and triggers a replan.

* **replan** -- `plan_net(..., costs=store)`: measured seconds override
  the tier-ranked roofline choice per layer and the saved-vs-extra
  model per fusion group.  A candidate identical to the live plan is a
  no-op (audited; cooldown applies).

* **shadow** -- the runtime's wave observer duplicates a
  `shadow_fraction` trickle of live waves onto the candidate, strictly
  after live results and latency histograms are recorded (shadow work
  can never count toward client SLOs).  Exactness mode is picked
  automatically: bitwise when the candidate keeps the live per-layer
  algorithms (fusion-structure-only change -- the untiled fused path IS
  the unfused computation), the documented ~1e-3 cross-family tolerance
  otherwise.

* **promote / rollback** -- on a clean latency win the candidate is
  `hot_swap`ped in (warm, atomic, surgically cache-invalidated); on any
  mismatch or a measured loss the candidate is discarded and the old
  program keeps serving.  Every transition lands in a reason-coded
  audit log and the `adapt.*` telemetry counters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import registry
from repro_torch.convserve import planner
from repro_torch.convserve.adapt.costs import MeasuredCostStore, stage_key
from repro_torch.convserve.adapt.shadow import ShadowVerifier
from repro_torch.convserve.adapt.swap import hot_swap
from repro_torch.convserve.obs.trace import CAT_ADAPT
from repro_torch.convserve.check.ir import verify_program
from repro_torch.core.device import host_array

IDLE = "idle"
SHADOW = "shadow"


@dataclasses.dataclass
class AdaptConfig:
    """Knobs of the control loop (see README "Adaptive replanning")."""

    divergence_ratio: float = 2.0  # stage ratio vs store median that triggers
    min_samples: int = 1           # stage observations before it is judged
    shadow_fraction: float = 0.25  # fraction of live waves duplicated
    shadow_min_waves: int = 3      # clean paired samples before a verdict
    promote_margin: float = 0.0    # candidate may be this much slower and win
    exactness: str = "auto"        # "auto" | "bitwise" | "rtol"
    rtol: float = 1e-3             # cross-family tolerance (fused vs direct)
    cooldown_s: float = 1.0        # after rollback/no-op, before re-checking
    probe_batch: int = 1
    probe_bucket: Optional[int] = None  # default: smallest runtime bucket
    probe_reps: int = 1
    consider_fft: bool = True
    swap_timeout_s: float = 5.0
    # stale-telemetry guard: a replan trigger whose telemetry stamp has
    # not advanced since the previous trigger (or whose last mutation is
    # older than `stale_after_s`) is counted + audited; with
    # `require_fresh_telemetry` it is also suppressed until fresh
    # evidence arrives.
    require_fresh_telemetry: bool = False
    stale_after_s: Optional[float] = None


class AdaptController:
    """One net's adaptive replanning loop over a live `ServeRuntime`.

    `probe` injects the stage-timing function (``probe(net, bucket,
    batch) -> [(label, seconds)]``; defaults to the executor's real
    `profile_stages`) and `shadow_timer` the latency pairing
    (``shadow_timer(result, cand_s) -> (live_s, cand_s)``; defaults to
    wall times) -- both exist so SimClock tests are deterministic.  The
    default store keys its measurements by the engine's device.
    """

    def __init__(
        self,
        runtime,
        engine,
        spec,
        weights: Dict[int, np.ndarray],
        cfg: Optional[AdaptConfig] = None,
        *,
        store: Optional[MeasuredCostStore] = None,
        probe=None,
        shadow_timer=None,
    ):
        self.runtime = runtime
        self.engine = engine
        self.spec = spec
        self.weights = weights
        self.cfg = cfg or AdaptConfig()
        self.store = store or MeasuredCostStore(
            clock=runtime.clock, device=engine.device
        )
        self._probe = probe
        self._shadow_timer = shadow_timer
        self.state = IDLE
        self.paused = False  # scale events gate shadow traffic off
        self._pause_reason: Optional[str] = None
        self.candidate: Optional[List] = None  # per-replica CompiledNets
        self.candidate_plan = None
        self.verifier: Optional[ShadowVerifier] = None
        self.last_verifier: Optional[ShadowVerifier] = None
        self.replans_triggered = 0
        self.shadows_run = 0
        self.promotions = 0
        self.rollbacks = 0
        self.audit: List[dict] = []
        self.stale_checks = 0
        self._last_check_seq = -1
        self._waves_seen = 0
        self._cooldown_until = -float("inf")
        runtime.add_wave_observer(self.on_wave)

    # ------------------------------------------------------- helpers

    @property
    def live(self):
        """Replica 0's CompiledNet -- the program traffic runs on."""
        return self.runtime.pool.executors[0]

    def _now(self) -> float:
        return self.runtime.clock.now()

    def _audit(self, event: str, reason: str, **detail) -> None:
        self.audit.append(
            {"t": self._now(), "event": event, "reason": reason, **detail}
        )
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None:
            # mirror the audit trail into the trace, so a dumped ring
            # explains replans/verdicts/swaps on the same timeline as
            # the waves they affected
            tracer.instant(
                f"adapt.{event}", CAT_ADAPT, reason=reason, **detail
            )

    def _inc(self, name: str) -> None:
        self.runtime.telemetry.inc(f"adapt.{name}")

    def _bucket_batch(self) -> Tuple[int, int]:
        bucket = self.cfg.probe_bucket or min(self.runtime.cfg.buckets)
        return bucket, self.cfg.probe_batch

    def _profile(self, net) -> List[Tuple[str, float]]:
        """Warm per-stage seconds for `net` at the probe geometry."""
        bucket, batch = self._bucket_batch()
        if self._probe is not None:
            return self._probe(net, bucket, batch)
        c0 = net.spec.conv_layers()[0][1].c_in
        x = np.zeros((batch, bucket, bucket, c0), np.float32)
        rows = net.profile_stages(x)
        for _ in range(self.cfg.probe_reps - 1):
            rows = [
                (lab, min(t, t2))
                for (lab, t), (_, t2) in zip(rows, net.profile_stages(x))
            ]
        return rows

    def _record_program(self, net) -> None:
        """Probe `net` and fold each stage's (measured, predicted) pair
        into the store, keyed by stage structure -- measurements for a
        probe-only program transfer to any plan posing the same stage."""
        hw = self.engine.hw
        measured = self._profile(net)
        predicted = planner.predict_stage_times(net.program, hw)
        for stage, (label, t_meas), (_, t_pred) in zip(
            net.program.stages, measured, predicted
        ):
            self.store.observe(
                stage_key(stage, self.store.backend), t_meas,
                predicted_s=t_pred,
            )

    # ------------------------------------------------------- pausing

    def pause(self, reason: str = "scale_event") -> None:
        """Suspend the control loop: no new replans open and -- the part
        scale events care about -- `on_wave` duplicates NOTHING while
        paused, so shadow compute never competes with replicas that are
        warming up or draining.  An open shadow keeps its candidate and
        evidence; `resume` picks up exactly where it stopped."""
        if self.paused:
            return
        self.paused = True
        self._pause_reason = reason
        self._inc("paused")
        self._audit("pause", reason)

    def resume(self) -> None:
        if not self.paused:
            return
        self.paused = False
        self._audit("resume", f"was paused for {self._pause_reason}")
        self._pause_reason = None

    # ------------------------------------------------------- measure

    def measure(self) -> None:
        """Profile the LIVE program's stages into the cost store."""
        self._record_program(self.live)

    def probe_alternatives(
        self, include: Sequence[str] = ("unfused", "direct")
    ) -> List[str]:
        """Measure the plans the replanner may switch to.  Probe
        programs share the engine's kernel cache (an unfused probe of a
        fused plan reuses the live transforms) and are discarded after
        timing; only their measurements persist."""
        probed = []
        live_plan = self.live.plan
        if "unfused" in include and live_plan.groups:
            plan = dataclasses.replace(live_plan, groups=())
            net = self.engine.compile(
                self.spec, self.weights, plan=plan, fuse=None
            )
            self._record_program(net)
            probed.append("unfused")
        if "direct" in include:
            h, w = live_plan.input_hw
            net = self.engine.compile(
                self.spec, self.weights, input_hw=(h, w),
                allowed=("direct",), fuse=False,
            )
            if net.plan.algos() != live_plan.algos():
                self._record_program(net)
                probed.append("direct")
        return probed

    # ------------------------------------------------------ diverge

    def _best_alternative_s(self, stage) -> Optional[float]:
        """Measured seconds of the fastest MEASURED alternative
        realization of this stage's layers: the unfused member sum for a
        fused stage, and the per-layer best measured algorithm either
        way.  None until `probe_alternatives` has populated the store."""
        plans = [u.plan for u in stage.units]
        alts = []
        if stage.fused:
            singles = [
                self.store.algo_time_s(p.algo, p.spec) for p in plans
            ]
            if all(t is not None for t in singles):
                alts.append(sum(singles))
        totals = []
        for p in plans:
            best = None
            for name in registry.names():
                alg = registry.get(name)
                if not (alg.auto_candidate and alg.supports(p.spec)):
                    continue
                t = self.store.algo_time_s(name, p.spec)
                if t is not None and (best is None or t < best):
                    best = t
            totals.append(best)
        if totals and all(t is not None for t in totals):
            alts.append(sum(totals))
        return min(alts) if alts else None

    def divergence(self) -> List[dict]:
        """Per-live-stage divergence rows, two currencies:

        * ``divergence`` -- measured/predicted ratio relative to the
          store-wide median ratio.  Scale-free: a uniformly
          mis-calibrated peak-FLOPs constant reads as 1.0 everywhere,
          while one stage whose misprediction stands out reads high.
        * ``regret`` -- measured live seconds over the measured-best
          alternative realization of the same layers.  Catches the
          uniform-calibration case the ratio signal cannot: the model
          predicted fused fastest, measurement says otherwise.
        """
        scale = self.store.ratio_scale()
        rows = []
        for stage in self.live.program.stages:
            e = self.store.entry(stage_key(stage, self.store.backend))
            if e is None or e.n < self.cfg.min_samples or e.ratio is None:
                continue
            alt = self._best_alternative_s(stage)
            rows.append(
                {
                    "stage": stage.label,
                    "measured_s": e.measured_s,
                    "predicted_s": e.predicted_s,
                    "ratio": e.ratio,
                    "divergence": e.ratio / scale,
                    "alternative_s": alt,
                    "regret": (
                        e.measured_s / alt if alt and alt > 0 else None
                    ),
                }
            )
        return rows

    def check(self) -> Optional[str]:
        """Divergence gate: when a live stage's measured/predicted ratio
        stands `divergence_ratio`x above the store median, re-plan with
        measured costs and open a shadow.  Returns the trigger reason,
        or None (in cooldown / already shadowing / within threshold /
        replan was a no-op)."""
        if self.paused:
            return None
        if self.state != IDLE or self._now() < self._cooldown_until:
            return None
        rows = self.divergence()
        if not rows:
            return None

        def signal(r):
            return max(r["divergence"], r["regret"] or 0.0)

        worst = max(rows, key=signal)
        if signal(worst) < self.cfg.divergence_ratio:
            return None
        if (worst["regret"] or 0.0) >= worst["divergence"]:
            reason = (
                f"stage {worst['stage']} measured {worst['regret']:.2f}x "
                f"over the best measured alternative"
            )
        else:
            reason = (
                f"stage {worst['stage']} measured "
                f"{worst['divergence']:.2f}x over prediction scale"
            )
        if self._stale_guard():
            return None
        self.replans_triggered += 1
        self._inc("replans_triggered")
        self._audit("replan", reason, divergence=worst["divergence"])
        if self._open_shadow() is None:
            return None
        return reason

    def _stale_guard(self) -> bool:
        """True when a would-be replan must be suppressed because the
        runtime's telemetry snapshot is stale (seq unchanged since the
        last trigger, or data older than `stale_after_s`).  Stale
        triggers are always counted + audited; only
        `require_fresh_telemetry` turns that into suppression."""
        telemetry = getattr(self.runtime, "telemetry", None)
        if telemetry is None:
            return False
        stamp = telemetry.stamp()
        seq_stale = stamp["seq"] == self._last_check_seq
        age = (
            self._now() - stamp["t"]
            if stamp["t"] is not None and self.cfg.stale_after_s is not None
            else None
        )
        age_stale = age is not None and age > self.cfg.stale_after_s
        if not seq_stale and not age_stale:
            self._last_check_seq = stamp["seq"]
            return False
        self.stale_checks += 1
        self._inc("stale_snapshot")
        self._audit(
            "stale_telemetry",
            (
                f"telemetry seq {stamp['seq']} unchanged since last trigger"
                if seq_stale
                else f"telemetry age {age:.3f}s > {self.cfg.stale_after_s}s"
            ),
            seq=stamp["seq"],
            blocked=self.cfg.require_fresh_telemetry,
        )
        return self.cfg.require_fresh_telemetry

    # ------------------------------------------------------- replan

    def _open_shadow(self):
        """Re-plan with measured costs; compile + start shadowing the
        candidate (None when the replan reproduces the live plan)."""
        cfg = self.cfg
        live_plan = self.live.plan
        h, w = live_plan.input_hw
        plan = planner.plan_net(
            self.spec, h, w,
            hw=self.engine.hw, dtype=live_plan.dtype,
            consider_fft=cfg.consider_fft, fuse=True, costs=self.store,
        )
        if plan == live_plan:
            self._audit("replan_noop", "measured costs reproduce live plan")
            self._cooldown_until = self._now() + cfg.cooldown_s
            return None
        # static verification gate: a candidate that fails the IR
        # verifier is reason-coded rejected here -- it never compiles,
        # never receives shadow traffic
        report = verify_program(self.spec, plan, hw=self.engine.hw)
        if report.errors:
            codes = ",".join(sorted({d.code for d in report.errors}))
            self._inc("verify_rejected")
            self._audit(
                "replan_rejected",
                f"candidate failed static verification [{codes}]",
                codes=codes,
            )
            self._cooldown_until = self._now() + cfg.cooldown_s
            return None
        n = len(self.runtime.pool.executors)
        self.candidate = [
            self.engine.compile(self.spec, self.weights, plan=plan, fuse=None)
            for _ in range(n)
        ]
        self.candidate_plan = plan
        mode = cfg.exactness
        if mode == "auto":
            mode = (
                "bitwise" if plan.algos() == live_plan.algos() else "rtol"
            )
        self.verifier = ShadowVerifier(
            mode=mode, rtol=cfg.rtol,
            min_waves=cfg.shadow_min_waves,
            promote_margin=cfg.promote_margin,
        )
        self.state = SHADOW
        self._audit(
            "shadow_open",
            f"candidate algos {'+'.join(plan.algos())}, "
            f"{len(plan.groups)} groups (live {len(live_plan.groups)}), "
            f"exactness {mode}",
        )
        return self.candidate

    # ------------------------------------------------------- shadow

    def on_wave(self, result) -> None:
        """Runtime wave observer: duplicate a trickle of live waves onto
        the candidate.  Runs strictly after the live wave's client-side
        bookkeeping, so shadow work never touches client latency."""
        if self.paused:
            return
        if self.state != SHADOW or self.candidate is None:
            return
        self._waves_seen += 1
        f = self.cfg.shadow_fraction
        n = self._waves_seen
        if int(n * f) <= int((n - 1) * f):
            return
        self.shadows_run += 1
        self._inc("shadows_run")
        ex = self.candidate[0]
        batch, sizes = result.wave.assemble()
        before = ex.compile_count
        # the POOL's clock, not the runtime's: live waves are timed on it
        # (`ReplicaPool._run`), so shadow/live latency pairs compare on
        # one timeline whichever clock is injected
        clock = self.runtime.pool.clock
        t0 = clock.now()
        # the copy to the host waits for the device: cand_s is complete
        y = host_array(ex(batch, sizes))
        cand_s = clock.now() - t0
        cand_cold = ex.compile_count > before
        outputs = result.wave.crop(self.spec, y)
        if self._shadow_timer is not None:
            live_s, cand_s = self._shadow_timer(result, cand_s)
        else:
            live_s = result.compute_s
        self.runtime.telemetry.observe("adapt.shadow_compute", cand_s)
        exact = self.verifier.record(
            result.outputs, outputs,
            live_compute_s=live_s, cand_compute_s=cand_s,
            cold=cand_cold or result.compiled,
        )
        if not exact:
            self._rollback("shadow_inexact")
            return
        verdict = self.verifier.verdict()
        if verdict == "promote":
            self._promote()
        elif verdict == "rollback":
            self._rollback("shadow_slower")

    # ------------------------------------------- promote / rollback

    def _promote(self) -> None:
        v = self.verifier
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None and tracer.active:
            # the candidates were compiled untraced; the promoted
            # program must keep recording stage/profile spans
            from repro_torch.convserve.obs.trace import attach

            for net in self.candidate:
                attach(net, tracer)
        hot_swap(
            self.runtime.pool, self.candidate,
            scheduler=self.runtime.scheduler,
            timeout_s=self.cfg.swap_timeout_s,
        )
        self.promotions += 1
        self._inc("promotions")
        self._audit(
            "promote",
            f"candidate {v.cand_mean_s:.6f}s <= live {v.live_mean_s:.6f}s "
            f"over {len(v.cand_s)} shadow waves",
        )
        self._close_shadow()

    def _rollback(self, reason: str) -> None:
        self.rollbacks += 1
        self._inc("rollbacks")
        v = self.verifier
        detail = (
            f"{v.mismatches} mismatched waves"
            if reason == "shadow_inexact"
            else (
                f"candidate {v.cand_mean_s:.6f}s > live {v.live_mean_s:.6f}s"
                if v.cand_mean_s is not None and v.live_mean_s is not None
                else "insufficient shadow evidence"
            )
        )
        self._audit("rollback", reason, detail=detail)
        self._close_shadow()

    def _close_shadow(self) -> None:
        self.last_verifier = self.verifier
        self.candidate = None
        self.candidate_plan = None
        self.verifier = None
        self.state = IDLE
        self._waves_seen = 0
        self._cooldown_until = self._now() + self.cfg.cooldown_s

    # --------------------------------------------------------- stats

    def stats(self) -> dict:
        v = self.verifier or self.last_verifier
        return {
            "state": self.state,
            "paused": self.paused,
            "replans_triggered": self.replans_triggered,
            "shadows_run": self.shadows_run,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "stale_checks": self.stale_checks,
            "store_entries": len(self.store),
            "store_scale": self.store.ratio_scale(),
            "divergence": self.divergence(),
            "shadow": v.stats() if v is not None else None,
            "audit": list(self.audit),
        }
