"""Shadow A/B verifier: the gate between a candidate plan and traffic.

A candidate `ExecProgram` is never promoted on the replanner's say-so:
a trickle of live waves is duplicated onto it (on a spare replica,
after the live wave's results are already recorded -- shadow work can
never show up in a client latency histogram) and this verifier
accumulates two things per shadow wave:

* exactness -- every duplicated request's candidate output against the
  live output.  ``bitwise`` mode demands equality to the bit (the right
  bar when the candidate keeps the live per-layer algorithms and only
  changes fusion structure: the untiled fused path IS the unfused
  computation); ``rtol`` allows the documented cross-family tolerance
  (fused-FFT vs direct agree to ~1e-3 relative).  One mismatch is
  disqualifying -- exactness is not a statistic.

* latency -- live vs candidate compute seconds, cold samples excluded
  on both sides (either side jitting mid-shadow is a one-time cost, not
  a property of the plan).

`verdict()` stays None until `min_waves` clean comparisons have
accumulated, then answers "promote" iff the candidate's mean compute is
within `promote_margin` of live (and strictly "rollback" on any
mismatch, immediately, regardless of sample count).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ShadowVerifier:
    """Accumulates exactness + latency evidence for one candidate."""

    def __init__(
        self,
        *,
        mode: str = "bitwise",
        rtol: float = 1e-3,
        atol: float = 1e-5,
        min_waves: int = 3,
        promote_margin: float = 0.0,
    ):
        if mode not in ("bitwise", "rtol"):
            raise ValueError(f"unknown exactness mode {mode!r}")
        self.mode = mode
        self.rtol = rtol
        self.atol = atol
        self.min_waves = min_waves
        self.promote_margin = promote_margin
        self.waves = 0
        self.requests = 0
        self.mismatches = 0
        self.live_s: List[float] = []
        self.cand_s: List[float] = []
        self.cold_skipped = 0

    def record(
        self,
        live_outputs: Dict[int, np.ndarray],
        cand_outputs: Dict[int, np.ndarray],
        *,
        live_compute_s: Optional[float] = None,
        cand_compute_s: Optional[float] = None,
        cold: bool = False,
    ) -> bool:
        """Fold one shadow wave in; returns whether it was exact."""
        self.waves += 1
        exact = True
        for rid, live in live_outputs.items():
            cand = cand_outputs.get(rid)
            self.requests += 1
            if cand is None:
                exact = False
            elif self.mode == "bitwise":
                exact &= bool(np.array_equal(live, cand))
            else:
                exact &= bool(
                    np.allclose(live, cand, rtol=self.rtol, atol=self.atol)
                )
        if not exact:
            self.mismatches += 1
        if cold:
            self.cold_skipped += 1
        elif live_compute_s is not None and cand_compute_s is not None:
            self.live_s.append(live_compute_s)
            self.cand_s.append(cand_compute_s)
        return exact

    @property
    def live_mean_s(self) -> Optional[float]:
        return sum(self.live_s) / len(self.live_s) if self.live_s else None

    @property
    def cand_mean_s(self) -> Optional[float]:
        return sum(self.cand_s) / len(self.cand_s) if self.cand_s else None

    def verdict(self) -> Optional[str]:
        """"promote" / "rollback" once the evidence is in, else None.
        Any mismatch rolls back immediately; latency needs `min_waves`
        clean (warm, paired) samples before it may promote."""
        if self.mismatches:
            return "rollback"
        if len(self.cand_s) < self.min_waves:
            return None
        live, cand = self.live_mean_s, self.cand_mean_s
        if cand <= live * (1.0 + self.promote_margin):
            return "promote"
        return "rollback"

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "waves": self.waves,
            "requests": self.requests,
            "mismatches": self.mismatches,
            "cold_skipped": self.cold_skipped,
            "paired_samples": len(self.cand_s),
            "live_mean_s": self.live_mean_s,
            "cand_mean_s": self.cand_mean_s,
        }
