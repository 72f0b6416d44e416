"""Block shapes for the parametric tile kernel.

One frozen record carries everything the autotuner can move:

  * ``r``                 -- tiles per task (row-block of the mix GEMMs;
                             the paper's R, bounded by shared-memory
                             capacity via ``analysis.max_r_ta``).  The
                             CUDA kernel runs one task of R tiles per
                             thread block.
  * ``tasks_per_program`` -- on the matrix path the product
                             ``r * tasks_per_program`` becomes the tile
                             chunk of one sweep; the sentinel 0 means
                             "unchunked" -- the whole tile population in
                             one GEMM chain.  The CUDA kernel's blocks
                             are independent, so it reads only ``r``.
  * ``mix_block``         -- unroll factor of the S-point channel-mix
                             loop, kept so wisdom entries written by the
                             reference package load unchanged

Serialized as a plain dict under the ``"blocks"`` field of a wisdom
entry so it rides the existing ``backend:family:geometry`` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    r: int
    tasks_per_program: int = 0
    mix_block: int = 8

    def chunk(self) -> int:
        """Tiles per sweep on the matrix path (0 = whole population)."""
        if self.tasks_per_program <= 0:
            return 0
        return self.r * self.tasks_per_program

    def to_wisdom(self) -> dict:
        return {
            "r": int(self.r),
            "tpp": int(self.tasks_per_program),
            "mix": int(self.mix_block),
        }

    @classmethod
    def from_wisdom(cls, d: Mapping) -> Optional["BlockConfig"]:
        try:
            return cls(
                r=int(d["r"]),
                tasks_per_program=int(d.get("tpp", 0)),
                mix_block=int(d.get("mix", 8)),
            )
        except (KeyError, TypeError, ValueError):
            return None
