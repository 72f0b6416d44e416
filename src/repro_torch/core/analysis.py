"""The paper's S5 analytical (roofline) model, as executable code.

Used two ways:
  * the registry and the convserve planner price every algorithm and
    fusion group through it (`fused_cost_ta`, `max_r_ta`, ...)
  * `choose_algo` implements the paper's "wisdom file" remark: pick the
    fused algorithm exactly where the model predicts it wins
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    peak_flops: float  # FLOP/s (fp32)
    dram_bw: float  # bytes/s main memory (HBM on the GPU)
    fast_shared_bw: float  # bytes/s of the shared fast level (L3 / GPU L2)
    fast_shared_bytes: int  # capacity of that level
    private_bytes: int  # per-core private working memory (L2 / shared memory)

    @property
    def cmr_dram(self) -> float:
        return self.peak_flops / self.dram_bw

    @property
    def cmr_fast(self) -> float:
        return self.peak_flops / self.fast_shared_bw


# The two machines of the paper's S6, numbers from the text.
SKYLAKE_X = HardwareModel(
    name="i9-7980xe (18c, AVX512)",
    peak_flops=2.6e9 * 18 * 2 * 16 * 2,  # 2 FMA ports x 16 fp32 lanes
    dram_bw=4 * 21.3e9,
    fast_shared_bw=(2.6e9 * 18 * 2 * 16 * 2) / 10.0,  # paper: CMR_L3 ~ 10
    fast_shared_bytes=20 * 2**20,
    private_bytes=1 * 2**20,
)
# AVX-heavy code downclocks below the 3.1 GHz nominal: the paper reports
# CMR_dram = 13, implying ~2.6 GHz effective (13 * 25.6 GB/s = 332.8 GFLOP/s).
_I7_PEAK = 13.0 * (2 * 12.8e9)
MOBILE_I7 = HardwareModel(
    name="i7 MacBookPro (4c, AVX2)",
    peak_flops=_I7_PEAK,
    dram_bw=2 * 12.8e9,
    fast_shared_bw=_I7_PEAK / 4.0,  # paper: CMR_L3 ~ 4
    fast_shared_bytes=8 * 2**20,
    private_bytes=256 * 2**10,
)
# One NVIDIA H100 SXM, from the card's data sheet.  The paper's levels map
# as: private L2 -> a block's shared memory (the per-block opt-in limit,
# so `max_r_ta` sizes R to fit the tile kernel's aliased buffer), shared
# L3 -> the 50 MB L2 that holds the stationary right-hand matrices,
# DRAM -> HBM3.  `peak_flops` is fp32 outside the tensor cores: the tile
# kernel computes in fp32 FMAs.
_H100_FP32 = 67e12
H100_SXM = HardwareModel(
    name="H100 SXM (fp32, data sheet)",
    peak_flops=_H100_FP32,
    dram_bw=3.35e12,
    # placeholder: CMR_fast = 4 until the L2 feed rate is calibrated on
    # the card -- this number sets min_r (R >= 2 CMR_fast = 8)
    fast_shared_bw=_H100_FP32 / 4.0,
    fast_shared_bytes=50 * 2**20,
    private_bytes=232_448,
)


def calibrated_hw(
    base: "HardwareModel | None" = None,
    wisdom_path=None,
    *,
    measure: bool = True,
    device=None,
) -> HardwareModel:
    """`base` with its compute and memory roofs replaced by the one-shot
    GEMM/stream microbenchmark (`tune.measure_calibration`, cached in the
    wisdom file per backend) on `device` (the card unless the caller
    names another; raises without one, as every entry point does).

    Only the absolute roofs change: `fast_shared_bw` is rescaled to
    preserve the base model's CMR_fast, so the *structure* of planning
    (min_r, the R bounds, fusion-group thresholds) is untouched while
    every absolute time prediction is anchored to this device.  With
    `measure=False` only a cached calibration is consulted (never pays
    the microbenchmark) and `base` is returned verbatim when none exists.
    """
    from repro_torch.core import tune  # deferred: tune imports this module
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)
    base = base or tune.default_hw(dev)
    entry = (
        tune.measure_calibration(wisdom_path, device=dev)
        if measure
        else tune.lookup_calibration(wisdom_path, dev)
    )
    if not entry:
        return base
    peak = float(entry["peak_flops"])
    return dataclasses.replace(
        base,
        name=base.name + ":calibrated",
        peak_flops=peak,
        dram_bw=float(entry["dram_bw"]),
        fast_shared_bw=peak / base.cmr_fast,
    )


def kernel_matrix_bytes(c_in: int, c_out: int, t: int) -> int:
    """Right-hand matrices: 4 C C' T^2 bytes (the fp32 Winograd case; the
    family-exact figure -- complex pairs over the rfft half-spectrum for
    FFT, grouped block-diagonal -- is `TileAlgebra.kernel_matrix_bytes`)."""
    return 4 * c_in * c_out * t * t


def task_flops(r: int, c_in: int, c_out: int, t: int, alpha: int = 1) -> int:
    """alpha 2 R C C' T^2 -- matmul FLOPs per task (alpha=1 Wino, 2 FFT)."""
    return alpha * 2 * r * c_in * c_out * t * t


def ai_fast_level(r: int) -> float:
    """Arithmetic intensity against the shared fast level == R/2 (paper S5.1)."""
    return r / 2.0


def ai_dram(
    c_in: int, c_out: int, t: int, t_out: int, alpha: int = 1, groups: int = 1
) -> float:
    """AI against main memory: FLOPs / (input+output tile bytes).

    Activations stream through DRAM as real fp32 regardless of transform
    family (the complex domain lives only in fast memory), so the byte
    term is family-independent; grouped channel mixes are block-diagonal,
    dividing the FLOP term by `groups`.
    """
    flops = alpha * 2 * c_in * c_out * t * t // groups
    byts = 4 * t * t * c_in + 4 * t_out * t_out * c_out
    return flops / byts


def min_r(hw: HardwareModel) -> int:
    """Lower bound: R >= 2 CMR_fast for full utilisation at the shared level."""
    import math

    return int(math.ceil(2 * hw.cmr_fast))


def max_r(hw: HardwareModel, c_in: int, c_out: int, t: int) -> int:
    """Upper bound from the shared buffer fitting half the private memory."""
    from repro_torch.core.sharedbuf import max_r_for_budget

    return max_r_for_budget(hw.private_bytes // 2, c_in, c_out, t)


def max_r_ta(hw: HardwareModel, c_in: int, c_out: int, ta) -> int:
    """Family-exact R upper bound: the shared-buffer working set -- sized
    by the transform's domain points and element width (`TileAlgebra`) --
    must fit half the private memory.  Buffers hold full-width channels
    even for grouped problems (tiles are gathered whole), so no `groups`
    term here."""
    from repro_torch.core.sharedbuf import max_r_for_budget

    return max_r_for_budget(
        hw.private_bytes // 2, c_in, c_out, ta.t,
        points=ta.domain_points, elem_bytes=ta.elem_bytes,
    )


def predicted_utilization(
    hw: HardwareModel, r: int, c_in: int, c_out: int, t: int, t_out: int,
    alpha: int = 1, groups: int = 1,
) -> float:
    """min over memory levels of AI/CMR, capped at 1 (paper S2.3)."""
    u_fast = ai_fast_level(r) / hw.cmr_fast
    u_dram = ai_dram(c_in, c_out, t, t_out, alpha, groups) / hw.cmr_dram
    return min(1.0, u_fast, u_dram)


def conv_time_s(
    hw: HardwareModel,
    *,
    out_h: int,
    out_w: int,
    c_in: int,
    c_out: int,
    k: int,
    groups: int = 1,
    predicted_util: float = 1.0,
) -> float:
    """Modeled wall time of one conv: direct FLOP count over peak,
    derated by the predicted utilization (floored at 5% so a degenerate
    utilization estimate never produces an infinite time).  This is the
    roofline prediction that `convserve.adapt` compares measured stage
    times against."""
    flops = 2 * out_h * out_w * c_in * c_out * k * k // groups
    return flops / (hw.peak_flops * max(predicted_util, 0.05))


MATRIX_RESIDENCY_FRAC = 0.5  # paper S4.1.1's constant fraction -- the ONE
# copy: fused_is_feasible, fused_cost_ta, and the convserve fusion-group
# planner all gate on this same threshold


def fused_is_feasible(
    hw: HardwareModel,
    c_in: int,
    c_out: int,
    t: int,
    frac: float = MATRIX_RESIDENCY_FRAC,
) -> bool:
    """Right-hand matrices must occupy <= a constant fraction of shared fast
    memory (paper S4.1.1)."""
    return kernel_matrix_bytes(c_in, c_out, t) <= frac * hw.fast_shared_bytes


def flops_per_output_px(t: int, t_out: int, alpha: int = 1) -> float:
    """Matmul FLOPs per output pixel, in units of C*C' (the common factor):
    alpha 2 T^2 / T'^2.  Lets transform families with different tile sizes
    and alpha be compared on equal footing (time ~ flops/px / utilisation)."""
    return alpha * 2.0 * t * t / float(t_out * t_out)


def fused_cost_ta(
    hw: HardwareModel, c_in: int, c_out: int, ta, r_floor: int,
    groups: int = 1,
):
    """(algo-feasibility, modeled cost) of one fused transform family,
    seen through its `TileAlgebra` -- the entry the registry algorithms
    and the convserve planner share, so every family (and any future one)
    is costed by the same roofline with family-exact working-set terms.

    Cost is time per output pixel up to the common C*C' factor: flops/px
    divided by predicted utilisation at the best feasible R.  Returns
    None when infeasible (matrices overflow the shared level, or no
    useful R fits the private-memory budget).
    """
    if ta.t_out < 1:
        return None
    matrix = ta.kernel_matrix_bytes(c_in, c_out, groups)
    if matrix > MATRIX_RESIDENCY_FRAC * hw.fast_shared_bytes:
        return None
    r_hi = max_r_ta(hw, c_in, c_out, ta)
    if r_hi < r_floor:
        return None
    r = min(r_hi, max(min_r(hw), r_floor))
    u = predicted_utilization(
        hw, r, c_in, c_out, ta.t, ta.t_out, ta.alpha, groups
    )
    return ta.flops_per_output_px() / max(u, 1e-9)


def engine_cost_ta(
    hw: HardwareModel, c_in: int, c_out: int, ta, r: int,
    groups: int = 1, stride: int = 1,
):
    """Block-aware fused cost: the parametric tile engine's *actual* MAC
    count (forward basis GEMM + channel mix + inverse basis GEMM, see
    `TileAlgebra.engine_macs_per_tile`) per final output pixel, in the
    same C*C' units as `fused_cost_ta`, at the *tuned* block's R
    utilisation.  The engine always computes the full stride-1 tile grid
    and decimates, so strided problems simply have stride^2 fewer final
    pixels per tile -- the decimation waste falls out of the
    normalization instead of being bolted on as a separate penalty.
    Returns None when infeasible (same residency gate as the analytic
    path)."""
    if ta.t_out < 1:
        return None
    matrix = ta.kernel_matrix_bytes(c_in, c_out, groups)
    if matrix > MATRIX_RESIDENCY_FRAC * hw.fast_shared_bytes:
        return None
    u = predicted_utilization(
        hw, max(1, r), c_in, c_out, ta.t, ta.t_out, ta.alpha, groups
    )
    px_units = (
        2.0 * ta.engine_macs_per_tile(c_in, c_out, groups) * stride**2
        / (ta.t_out**2 * c_in * c_out)
    )
    return px_units / max(u, 1e-9)


def fused_cost(
    hw: HardwareModel, c_in: int, c_out: int, t: int, k: int, alpha: int,
    r_floor: int,
):
    """Closed-form (t, k, alpha) view of `fused_cost_ta`, kept for
    `choose_algo` (the paper-table three-way choice) and the algebra
    tests.  alpha selects the family's TileAlgebra."""
    from repro_torch.core import transforms

    if t <= k:
        return None
    ta = (
        transforms.FFTTransform(t=t, k=k)
        if alpha == 2
        else transforms.WinogradTransform(m=t - k + 1, k=k)
    ).algebra
    return fused_cost_ta(hw, c_in, c_out, ta, r_floor)


def choose_algo(
    hw: HardwareModel,
    c_in: int,
    c_out: int,
    t: int,
    *,
    k: int = 3,
    t_fft: int = 16,
    consider_fft: bool = True,
) -> Literal["l3_fused", "fft_fused", "three_stage"]:
    """The "wisdom file" choice across all three transformed paths.

    Winograd-fused and FFT-fused are feasible where their right-hand
    matrices fit the shared level AND a useful R exists between the bounds;
    among feasible fused paths the one with the lower modeled time per
    output pixel (alpha=2 FLOP accounting for FFT) wins.  When no fused
    path is feasible the vendor 3-stage structure is the fallback.
    """
    wino = fused_cost(hw, c_in, c_out, t, k, 1, max(8, min_r(hw) // 2))
    fft = None
    if consider_fft:
        fft = fused_cost(
            hw, c_in, c_out, t_fft, k, 2, max(4, min_r(hw) // 2)
        )
    if wino is None and fft is None:
        return "three_stage"
    if fft is None or (wino is not None and wino <= fft):
        return "l3_fused"
    return "fft_fused"
