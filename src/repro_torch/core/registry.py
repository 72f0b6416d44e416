"""Unified convolution-algorithm registry.

The paper's central claim is that one transformed-conv *problem* admits
several interchangeable *realizations* (3-stage, L3-fused Winograd,
L3-fused FFT, direct) whose winner flips with layer geometry.  This module
makes that interchangeability first-class:

  * `ConvSpec` -- the problem: spatial dims, channels, kernel, pad,
    stride, groups, dtype.  Pure data, JSON-serializable.
  * `Algorithm` -- one realization: capabilities (`supports`), a cost
    entry wrapping the S5 roofline model, and the lifecycle

        plan(spec, hw)            -> AlgoPlan (algorithm-owned params)
        prepare_weights(w, plan)  -> right-hand matrices (or None)
        execute(x, w, wt, plan)   -> output

  * the registry itself -- `register`/`get`/`names`, and `plan_conv`,
    which resolves ``algo="auto"`` by ranking every supporting algorithm
    on (tier, modeled cost, rank) and resolves R through the wisdom file.

Adding an algorithm (or a new scenario: strided, grouped, ...) is a single
`register()` call -- `conv2d`, the convserve planner, the kernel cache,
and the executor all dispatch through here and never name algorithms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import analysis
from repro_torch.core.device import dtype_name


# --------------------------------------------------------------- ConvSpec


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """A 2-D convolution problem: NHWC x HWIO -> NHWC.

    `h`/`w` are the (possibly non-square) input spatial dims the problem
    was posed at; executors may apply a plan to other runtime shapes --
    the structural fields (k, pad, stride, groups, dtype) are what the
    algorithms condition on.

    **Temporal specs** (``h == 1`` with ``k > 1``) pose a 1-D problem:
    the kernel is 1 x k along `w` (a length-`w` sequence of `c` channels)
    and `pad` is interpreted as CAUSAL left-only padding along `w` --
    ``pad = k - 1`` gives a same-length causal conv, the shape sequence
    models use.  2-D algorithms must decline temporal specs in
    `supports` (symmetric-pad k x k semantics do not apply).
    """

    h: int
    w: int
    c_in: int
    c_out: int
    k: int
    pad: int = 0
    stride: int = 1
    groups: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if min(self.h, self.w, self.c_in, self.c_out, self.k) < 1:
            raise ValueError(f"non-positive dimension in {self}")
        if self.pad < 0 or self.stride < 1 or self.groups < 1:
            raise ValueError(f"bad pad/stride/groups in {self}")
        if self.c_in % self.groups or self.c_out % self.groups:
            raise ValueError(
                f"channels ({self.c_in}->{self.c_out}) not divisible by "
                f"groups {self.groups}"
            )
        if self.temporal:
            if self.w + self.pad < self.k:
                raise ValueError(f"kernel larger than padded sequence: {self}")
        elif self.h + 2 * self.pad < self.k or self.w + 2 * self.pad < self.k:
            raise ValueError(f"kernel larger than padded input: {self}")

    @property
    def temporal(self) -> bool:
        """1-D (causal) problem posed on the `w` axis: h == 1, k > 1."""
        return self.h == 1 and self.k > 1

    @staticmethod
    def from_tensors(
        x, w, *, pad: int = 0, stride: int = 1, groups: int = 1
    ) -> "ConvSpec":
        """Describe the problem posed by concrete NHWC x / HWIO w tensors."""
        if x.ndim != 4 or w.ndim != 4:
            raise ValueError(f"expected NHWC x and HWIO w, got {x.shape}, {w.shape}")
        if w.shape[0] != w.shape[1]:
            raise ValueError(f"only square kernels supported, got {w.shape}")
        if w.shape[2] * groups != x.shape[3]:
            raise ValueError(
                f"kernel c_in {w.shape[2]} x groups {groups} != input "
                f"channels {x.shape[3]}"
            )
        return ConvSpec(
            h=int(x.shape[1]), w=int(x.shape[2]),
            c_in=int(x.shape[3]), c_out=int(w.shape[3]), k=int(w.shape[0]),
            pad=pad, stride=stride, groups=groups,
            dtype=dtype_name(x.dtype),
        )

    @property
    def out_hw(self) -> Tuple[int, int]:
        if self.temporal:  # causal left-only pad along w, h untouched
            return (1, (self.w + self.pad - self.k) // self.stride + 1)
        return (
            (self.h + 2 * self.pad - self.k) // self.stride + 1,
            (self.w + 2 * self.pad - self.k) // self.stride + 1,
        )

    @property
    def padded_min(self) -> int:
        """Smallest padded spatial extent -- the tile-fit criterion."""
        return min(self.h, self.w) + 2 * self.pad

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping) -> "ConvSpec":
        return ConvSpec(**d)


# --------------------------------------------------------------- AlgoPlan


@dataclasses.dataclass(frozen=True)
class AlgoPlan:
    """One algorithm's resolved decision for one ConvSpec.

    `params` is algorithm-owned (m, t_fft, r_tiles, ...): nothing outside
    the owning algorithm interprets it, which is what lets the cache and
    executor stay algorithm-agnostic.  `cost` is the roofline-modeled time
    per output pixel used for auto ranking (inf == excluded from auto);
    it is not serialized.
    """

    algo: str
    spec: ConvSpec
    params: Dict[str, Any]
    predicted_util: float = 0.0
    cost: float = math.inf
    tuned: bool = False


def fused_auto_cost(
    spec: ConvSpec,
    hw: analysis.HardwareModel,
    ta,  # transforms.TileAlgebra
    r_floor: int,
    blocks=None,  # kernels.fused_tile.BlockConfig from wisdom, or None
) -> float:
    """Auto-ranking cost of one fused transform family on `spec`: inf when
    the padded input cannot cover a single T-tile or the roofline deems
    the family infeasible, else the modeled time per output pixel.

    With a wisdom-resolved block shape (`blocks`), the charge is the tile
    engine's actual MAC count at the tuned R (`analysis.engine_cost_ta`)
    -- decimation waste included via the per-final-pixel normalization,
    so no separate stride^2 penalty is added.  Without wisdom, the old
    analytic charge (`fused_cost_ta` x stride^2) stands as the fallback.
    Shared by every fused algorithm -- through each family's own
    `TileAlgebra` working-set terms -- so the feasibility gate cannot
    diverge and the planner's auto ranking picks the *transform* per
    layer, not just the algorithm."""
    if spec.padded_min < ta.t:
        return math.inf
    if blocks is not None:
        ec = analysis.engine_cost_ta(
            hw, spec.c_in, spec.c_out, ta, int(blocks.r),
            spec.groups, spec.stride,
        )
        if ec is not None:
            return ec
    fc = analysis.fused_cost_ta(
        hw, spec.c_in, spec.c_out, ta, r_floor, spec.groups
    )
    return math.inf if fc is None else fc * spec.stride**2


def decimate(y: torch.Tensor, stride: int) -> torch.Tensor:
    """Stride-s conv == stride-1 conv decimated: y_s[i,j] = y_1[s*i, s*j].

    The transformed algorithms (whose OLA tiling is inherently stride-1)
    gain strided output through this post-pass; their cost entries charge
    the stride^2 wasted pixels so auto ranking stays honest.
    """
    if stride == 1:
        return y
    return y[:, ::stride, ::stride, :]


# -------------------------------------------------------------- Algorithm


class ElementwiseOps:
    """Structured elementwise epilogue: a static op list plus its bias
    tensors, so fused kernels can fold the glue into their scatter phase
    instead of closing over arrays.

    `ops` is a tuple of ``("bias", Tensor(C',))`` and ``("relu",)``
    entries, applied in order.  Instances are callables ``y -> y`` --
    drop-in for the plain closures `ChainLink.elementwise` used to carry
    -- and `kernel_form()` exposes the (op tags, stacked bias rows) pair
    the CUDA tile kernel consumes: the rows enter the kernel as an
    input, the tags as launch arguments.
    """

    def __init__(self, ops: Sequence[Tuple]):
        self.ops = tuple(
            (op[0], op[1]) if op[0] == "bias" else ("relu",) for op in ops
        )

    def __call__(self, y):
        for op in self.ops:
            y = y + op[1] if op[0] == "bias" else torch.relu(y)
        return y

    def kernel_form(self):
        """(static op tuple, (n_bias, C') rows).  Bias entries become
        ("bias", row_index); rows is None when no biases appear."""
        tags, rows = [], []
        for op in self.ops:
            if op[0] == "bias":
                tags.append(("bias", len(rows)))
                rows.append(op[1].reshape(-1))
            else:
                tags.append(("relu",))
        return tuple(tags), (torch.stack(rows) if rows else None)


@dataclasses.dataclass(frozen=True)
class ChainLink:
    """One conv of a fusion-group chain, as `execute_staged` consumes it.

    `elementwise` is position-independent pointwise glue (bias, relu):
    a callable ``y -> y`` folded into the owning algorithm's task loop
    via `fuse_epilogue`, so inside a fused stage it runs on tile-resident
    data exactly as it does in a single stage.  `epilogue` is the
    position-*dependent* remainder (the ragged-batch extent mask): a
    callable ``(y, row0) -> y`` where `row0` is the global output-row
    offset of the region being computed -- tile-position-aware so ragged
    masking stays exact inside a fused stage.  Either may be None.
    """

    w: Optional[torch.Tensor]
    wt: Optional[torch.Tensor]
    plan: "AlgoPlan"
    epilogue: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    elementwise: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _pad0_plan(plan: "AlgoPlan", h: int, w: int) -> "AlgoPlan":
    """A plan for executing the same conv on an already-row/col-extended
    slice: pad folded into the slice, spec re-posed at the slice dims."""
    return dataclasses.replace(
        plan, spec=dataclasses.replace(plan.spec, pad=0, h=h, w=w)
    )


class Algorithm:
    """Base class: one convolution realization.

    Class attributes:
      name           registry key (also the `algo=` string).
      tier           auto-resolution tier: 0 fused, 1 staged fallback,
                     2 direct.  Lower tier wins regardless of cost --
                     this encodes the paper's preference order (fused
                     where feasible, vendor structure as fallback).
      rank           deterministic tie-break within a tier.
      consumes_wt    execute() accepts pre-transformed kernels (`wt`);
                     False means a supplied wt is an error, never ignored.
      weight_params  param names that shape `prepare_weights` output --
                     the kernel cache keys transforms on exactly these.
      auto_candidate False for explicit-only algorithms (planned only
                     when named).
      chain_family   transform-tiling family for cross-layer fusion
                     groups; None means this algorithm never chains (the
                     3-stage baseline *is* the materializing structure,
                     direct has nothing to keep resident).
    """

    name: str = ""
    tier: int = 0
    rank: int = 0
    consumes_wt: bool = False
    weight_params: Tuple[str, ...] = ()
    auto_candidate: bool = True
    chain_family: Optional[str] = None

    def supports(self, spec: ConvSpec) -> bool:
        """Correctness domain: can this algorithm compute `spec` at all?"""
        raise NotImplementedError

    def plan(
        self,
        spec: ConvSpec,
        hw: analysis.HardwareModel,
        *,
        hints: Optional[Mapping[str, Any]] = None,
        tune_r: bool = False,
        wisdom_path=None,
        device=None,
    ) -> AlgoPlan:
        """Resolve algorithm-owned params (and modeled cost) for `spec`.
        `tune_r` measures R on `device` (the wisdom-file pass) where the
        algorithm has an R to tune; the others ignore both.  Wisdom reads
        and writes are keyed by `device`, the device the plan runs on."""
        raise NotImplementedError

    def prepare_weights(self, w: torch.Tensor, plan: AlgoPlan):
        """HWIO kernels -> right-hand matrices; None when the algorithm
        has no ahead-of-time transform (direct)."""
        return None

    def execute(
        self,
        x: torch.Tensor,
        w: Optional[torch.Tensor],
        wt: Optional[torch.Tensor],
        plan: AlgoPlan,
    ) -> torch.Tensor:
        """Run the convolution.  Geometry comes from the runtime `x`
        (plans apply to whole shape buckets); structure (pad, stride,
        groups) and params come from the plan."""
        raise NotImplementedError

    def prepare_key(self, params: Mapping[str, Any]) -> Tuple:
        """The params subtuple that identifies `prepare_weights` output
        (cache key component).  R never fragments the cache."""
        return tuple((p, params.get(p)) for p in self.weight_params)

    def tile_algebra(self, plan: "AlgoPlan"):
        """The transform family's cost/working-set terms for this plan
        (`transforms.TileAlgebra`), or None for algorithms with no
        transform tiling (direct).  The fusion-group planner prices
        joint right-hand-matrix residency through this."""
        return None

    # ----- cross-layer fusion hooks (the ExecProgram staged contract)

    def can_chain(self, plan_a: "AlgoPlan", plan_b: "AlgoPlan") -> bool:
        """May a conv planned as `plan_a` (this algorithm) and the next
        conv planned as `plan_b` execute as one fusion-group stage?

        The default demands a shared tiling family and the geometry the
        generic `execute_staged` supports: unit stride and ungrouped
        channels on both sides.  Whether fusing *pays* (saved
        intermediate traffic vs halo recompute) is the planner's
        roofline call, not a capability question.
        """
        if self.chain_family is None:
            return False
        other = get(plan_b.algo)
        if other.chain_family != self.chain_family:
            return False
        for p in (plan_a, plan_b):
            if p.spec.stride != 1 or p.spec.groups != 1:
                return False
        return True

    def fuse_epilogue(
        self,
        plan: "AlgoPlan",
        epilogue: Optional[Callable[[torch.Tensor], torch.Tensor]],
    ) -> Callable:
        """Return ``(x, w, wt) -> y`` running this conv with the
        elementwise `epilogue` (bias/relu) folded in.  The base applies
        it after `execute`; fused algorithms override to fold it into
        their task loop so the glue runs on tile-resident data."""
        if epilogue is None:
            return lambda x, w, wt: self.execute(x, w, wt, plan)
        return lambda x, w, wt: epilogue(self.execute(x, w, wt, plan))

    def execute_staged(
        self,
        x: torch.Tensor,
        chain: Sequence[ChainLink],
        *,
        tile_rows: int,
    ) -> torch.Tensor:
        """Run a fusion-group chain of stride-1 convs over row super-tiles.

        The group's full intermediate activations are never materialized:
        each super-tile flows conv -> epilogue -> conv with a (K-1)-row
        halo recomputed at tile seams, so the live intermediate is
        bounded by `tile_rows` x W x C -- sized by the planner to stay
        resident in the fast shared level.  Borders are exact and free:
        each conv's zero padding is applied per-slice, and rows a window
        needs beyond a true tensor extent are supplied as that padding
        rather than computed -- the receptive-field recursion clamps to
        the true extent per level, so border tiles do no phantom work.

        Generic over any registered algorithm whose `execute` honours
        `plan.spec` pad at runtime shapes; overriding makes sense only
        for backends that fuse deeper than slice recompute.
        """
        convs = list(chain)
        if not convs:
            raise ValueError("empty fusion-group chain")
        heights = [int(x.shape[1])]
        for link in convs:
            s = link.plan.spec
            if s.stride != 1 or s.groups != 1:
                raise ValueError(
                    f"execute_staged supports stride-1 ungrouped chains, "
                    f"got {s}"
                )
            heights.append(heights[-1] + 2 * s.pad - s.k + 1)
        h_final = heights[-1]
        tile_rows = int(tile_rows) if tile_rows > 0 else h_final
        out_tiles = []
        a = 0
        while a < h_final:
            b = min(a + tile_rows, h_final)
            # receptive-field pass, clamped to each level's true extent:
            # rows a window needs beyond an extent are that conv's own
            # zero padding, re-supplied per slice below -- they are never
            # computed, so they need no inputs of their own.  `mat[i]` is
            # the row range of level i this tile materializes; `want[i]`
            # extends it by conv i's zero padding.
            mat = [(a, b)]
            want = [None] * len(convs)
            for i in reversed(range(len(convs))):
                s = convs[i].plan.spec
                lo, hi = mat[0]
                want[i] = (lo - s.pad, hi - s.pad + s.k - 1)
                mat.insert(
                    0, (max(want[i][0], 0), min(want[i][1], heights[i]))
                )
            t = x[:, mat[0][0] : mat[0][1]]
            for i, link in enumerate(convs):
                s = link.plan.spec
                (wlo, whi), (mlo, mhi) = want[i], mat[i]
                if (mlo - wlo, whi - mhi) == (s.pad, s.pad):
                    # the wanted halo is exactly the conv's own padding on
                    # both sides (whole-extent tiles): keep the plan's pad
                    # and skip the explicit copy -- identical structure to
                    # the unfused single stage
                    run_plan = dataclasses.replace(
                        link.plan,
                        spec=dataclasses.replace(
                            s, h=int(t.shape[1]), w=int(t.shape[2])
                        ),
                    )
                else:
                    # conv padding: wanted rows beyond the level's true
                    # extent, plus full-width column padding (tiles span W)
                    t = F.pad(  # last dim first: C, then W, then H
                        t, (0, 0, s.pad, s.pad, mlo - wlo, whi - mhi)
                    )
                    run_plan = _pad0_plan(
                        link.plan, int(t.shape[1]), int(t.shape[2])
                    )
                alg = get(link.plan.algo)
                # the conv's elementwise glue folds into its task loop
                # exactly as in a single stage; the output covers exactly
                # mat[i + 1] (no phantom rows to crop)
                t = alg.fuse_epilogue(run_plan, link.elementwise)(
                    t, link.w, link.wt
                )
                if link.epilogue is not None:
                    t = link.epilogue(t, mat[i + 1][0])
            out_tiles.append(t)
            a = b
        return (
            out_tiles[0]
            if len(out_tiles) == 1
            else torch.cat(out_tiles, dim=1)
        )


# --------------------------------------------------------------- registry


_REGISTRY: Dict[str, Algorithm] = {}


def register(alg: Algorithm) -> Algorithm:
    if not alg.name:
        raise ValueError(f"algorithm {alg!r} has no name")
    _REGISTRY[alg.name] = alg
    return alg


def _ensure_registered() -> None:
    """Algorithms self-register when their module is imported; importing
    the dispatcher pulls in every built-in algorithm module."""
    if "direct" not in _REGISTRY:
        import repro_torch.core.conv  # noqa: F401


def get(name: str) -> Algorithm:
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algo {name!r}, expected one of {names()} or 'auto'"
        ) from None


def names() -> Tuple[str, ...]:
    _ensure_registered()
    return tuple(_REGISTRY)


def supporting(spec: ConvSpec) -> Tuple[str, ...]:
    """Names of algorithms whose correctness domain covers `spec`."""
    _ensure_registered()
    return tuple(n for n, a in _REGISTRY.items() if a.supports(spec))


def plan_conv(
    spec: ConvSpec,
    hw: analysis.HardwareModel,
    *,
    algo: str = "auto",
    hints: Optional[Mapping[str, Any]] = None,
    allowed: Optional[Sequence[str]] = None,
    tune_r: bool = False,
    wisdom_path=None,
    device=None,
) -> AlgoPlan:
    """Resolve `spec` to a concrete AlgoPlan for `device`.

    algo="auto" ranks every supporting, feasible algorithm by
    (tier, modeled cost, rank) -- the registry form of the paper's wisdom
    choice.  An explicit algo plans unconditionally (feasibility heuristics
    only gate auto); unsupported specs raise.  R comes from the wisdom
    file when it holds a tuned one, else from the analytic model; with
    `tune_r` it is measured (and stored) for the winner only, never for
    losing candidates.
    """
    _ensure_registered()
    hints = dict(hints or {})
    if algo != "auto":
        alg = get(algo)
        if not alg.supports(spec):
            raise ValueError(
                f"algo {algo!r} does not support {spec} "
                f"(supported here: {supporting(spec)})"
            )
        return alg.plan(
            spec, hw, hints=hints, tune_r=tune_r, wisdom_path=wisdom_path,
            device=device,
        )
    best: Optional[AlgoPlan] = None
    best_key = None
    for name in (allowed if allowed is not None else names()):
        alg = get(name)
        if not alg.auto_candidate or not alg.supports(spec):
            continue
        cand = alg.plan(
            spec, hw, hints=hints, wisdom_path=wisdom_path, device=device
        )
        if not math.isfinite(cand.cost):
            continue  # roofline-infeasible: excluded from auto
        key = (alg.tier, cand.cost, alg.rank)
        if best_key is None or key < best_key:
            best, best_key = cand, key
    if best is None:
        raise ValueError(
            f"auto found no feasible algorithm for {spec}: supporting "
            f"algorithms are {supporting(spec)}, but the candidate set "
            f"was restricted to {tuple(allowed) if allowed is not None else names()} "
            "and roofline-infeasible candidates are excluded -- widen "
            "`allowed` or request an algorithm explicitly"
        )
    if tune_r:  # measure only the winner (the wisdom-file pass)
        best = get(best.algo).plan(
            spec, hw, hints=hints, tune_r=True, wisdom_path=wisdom_path,
            device=device,
        )
    return best
