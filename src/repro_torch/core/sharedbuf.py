"""Shared-buffer planner (paper S4.2).

The i-th matmul's result may overwrite left-hand matrices < i, never >= i
(matmuls cannot run in place).  Storing left-hand matrices right-aligned in
one buffer and writing results from the start reduces the fast-memory
working set from  T^2 (S_max + S_min)  to  T^2 S_max + S_min,
S_max = max(4RC, 4RC'), S_min = min(4RC, 4RC') -- almost 2x when C == C',
which in turn permits an ~2x larger R (paper: "relaxing the upper bound
almost by a factor of two").

We use a row-granular variant as the planner's model of a task's fast
memory (the CUDA tile kernel streams S in chunks instead and prices its
own layout in `kernels/fused_tile/kernel.py::smem_bytes`):  buffer shape
((T^2 + 1) * R, W) with W = max(C, C');
left-hand matrix s occupies rows [(s+1)R, (s+2)R) cols [0, C); result s is
written to rows [sR, (s+1)R) cols [0, C') -- landing exactly on the rows of
left-hand matrix s-1, which the s-th matmul no longer needs.  Space:
(T^2+1) * R * 4W = T^2 S_max + S_max; equal to the paper's bound when
C == C' and within S_max - S_min of it otherwise.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SharedBufferPlan:
    r: int
    c_in: int
    c_out: int
    t2: int  # domain matmuls: T^2 (Winograd) or T*(T/2+1) (rfft)
    elem_bytes: int = 4  # 4 for real domains, 8 for complex (FFT)

    @property
    def width(self) -> int:
        return max(self.c_in, self.c_out)

    @property
    def rows(self) -> int:
        return (self.t2 + 1) * self.r

    def lhs_row(self, s: int) -> int:
        """First buffer row of left-hand matrix s (s in [0, T^2))."""
        return (s + 1) * self.r

    def result_row(self, s: int) -> int:
        """First buffer row of result matrix s."""
        return s * self.r

    @property
    def bytes(self) -> int:
        return self.elem_bytes * self.rows * self.width

    @property
    def naive_bytes(self) -> int:
        """Separate-buffer working set: T^2 * (4RC + 4RC')."""
        return self.elem_bytes * self.t2 * self.r * (self.c_in + self.c_out)

    @property
    def paper_bound_bytes(self) -> int:
        """T^2 S_max + S_min (byte-granular bound from the paper)."""
        s_max = self.elem_bytes * self.r * max(self.c_in, self.c_out)
        s_min = self.elem_bytes * self.r * min(self.c_in, self.c_out)
        return self.t2 * s_max + s_min

    @property
    def savings(self) -> float:
        return 1.0 - self.bytes / self.naive_bytes

    def validate(self) -> None:
        """Prove the aliasing invariant: result s never touches lhs >= s."""
        for s in range(self.t2):
            res_end = self.result_row(s) + self.r
            assert res_end <= self.lhs_row(s), (
                f"result {s} rows [{self.result_row(s)}, {res_end}) overlap "
                f"lhs {s} rows starting {self.lhs_row(s)}"
            )


def max_r_for_budget(
    budget_bytes: int,
    c_in: int,
    c_out: int,
    t: int,
    *,
    shared: bool = True,
    points: int = 0,
    elem_bytes: int = 4,
) -> int:
    """Largest R whose working set fits `budget_bytes` (paper S5.2).

    `points`/`elem_bytes` generalize beyond fp32 Winograd: the number of
    stored domain elements per tile plane (defaults to T^2) and their
    width (8 for the FFT's complex domain) -- `TileAlgebra` supplies both.
    """
    t2 = points if points else t * t
    w = max(c_in, c_out)
    if shared:
        denom = elem_bytes * (t2 + 1) * w
    else:
        denom = elem_bytes * t2 * (c_in + c_out)
    return max(1, budget_bytes // denom)
