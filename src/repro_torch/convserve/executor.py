"""Planned-net executor: a thin runner over the `ExecProgram` IR.

The executor interprets nothing per layer: `program.lower` already
resolved the net into stages, each stage's elementwise glue is folded
into the owning algorithm's task loop (`Algorithm.fuse_epilogue`), and
fusion-group stages run whole chains of convs through
`Algorithm.execute_staged` without materializing the full intermediate
activation.  Pre-transformed kernels come from the `KernelCache`, fetched
once per call, so the cache counters are visible per request.  The net
runs eagerly on the executor's device: there is no whole-net compile
step (`compile_count` counts the distinct input shapes served, the
quantity bucketing bounds).

Ragged batches: images smaller than their bucket ride in zero-padded.
Zero padding alone is NOT enough for correctness -- the first conv writes
nonzero values into the padded margin (its taps reach real pixels), and
later same-padded convs bleed those back across the true-image edge.  So
when per-sample extents are supplied, every stage re-zeroes everything
beyond each sample's true extent before handing to the next (`sizes` is
data, not shape: masking costs one compare+multiply).  Inside a fusion
group the intermediate masks are applied tile-position-aware (the
epilogue callables carry the super-tile's row offset), so fused serving
stays exact.  With true dims divisible by the pool windows, pooling
windows never straddle the mask edge, which makes the padded run exactly
equal to running each image unpadded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import registry
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.convserve.cache import KernelCache, weights_fingerprint
from repro_torch.convserve.graph import NetSpec
from repro_torch.convserve.obs.trace import (
    CAT_PROFILE,
    CAT_STAGE,
    NULL_TRACER,
    capture_tile_phases,
)
from repro_torch.convserve.runtime.clock import Clock, RealClock
from repro_torch.convserve.plan import NetPlan
from repro_torch.convserve.program import EpilogueOp, ExecProgram, Stage, lower


def _mask_to_extent(
    x: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor, row0: int = 0
) -> torch.Tensor:
    """Zero rows >= hs[b] and cols >= ws[b] of an NHWC batch.  `row0` is
    the global row offset of `x` when it is a super-tile of a larger
    tensor (fusion-group interiors)."""
    rows = row0 + torch.arange(x.shape[1], device=x.device)
    cols = torch.arange(x.shape[2], device=x.device)
    keep = (rows[None, :, None] < hs[:, None, None]) & (
        cols[None, None, :] < ws[:, None, None]
    )  # (B, H, W)
    return torch.where(keep[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_epilogue(
    ops: Tuple[EpilogueOp, ...]
) -> Tuple[Tuple[EpilogueOp, ...], Tuple[EpilogueOp, ...]]:
    """(elementwise prefix, rest): the prefix folds into the algorithm's
    task loop; pools (and anything after them) run on assembled output."""
    for i, op in enumerate(ops):
        if not op.elementwise:
            return ops[:i], ops[i:]
    return ops, ()


class _Extent:
    """Per-sample true extents (ragged batches), or inert when the batch
    is dense.  Geometry updates mirror the ops applied."""

    def __init__(self, hs, ws):
        self.hs, self.ws = hs, ws

    @property
    def live(self) -> bool:
        return self.hs is not None

    def after_conv(self, spec) -> "_Extent":
        if not self.live:
            return self
        return _Extent(
            (self.hs + 2 * spec.pad - spec.k) // spec.stride + 1,
            (self.ws + 2 * spec.pad - spec.k) // spec.stride + 1,
        )

    def after_pool(self, window: int) -> "_Extent":
        if not self.live:
            return self
        return _Extent(self.hs // window, self.ws // window)

    def mask(self, x, row0: int = 0):
        return _mask_to_extent(x, self.hs, self.ws, row0) if self.live else x


def _maxpool(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    v = window
    return x.reshape(b, h // v, v, w // v, v, c).amax(dim=(2, 4))


class NetExecutor:
    """Runs a `NetSpec` lowered to an `ExecProgram` with cached kernel
    transforms, on one device."""

    def __init__(
        self,
        spec: NetSpec,
        weights: Dict[int, torch.Tensor],
        plan: NetPlan,
        *,
        cache: Optional[KernelCache] = None,
        dtype=torch.float32,
        clock: Optional[Clock] = None,
        device: DeviceLike = None,
        tracer=None,
    ):
        missing = [i for i, _ in spec.param_layers() if i not in weights]
        if missing:
            raise ValueError(f"weights missing for parameter layers {missing}")
        # lower() validates plan-vs-spec coverage, geometry, and the
        # fusion groups' structural legality
        self.program: ExecProgram = lower(spec, plan)
        self.spec = spec
        self.plan = plan
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else KernelCache()
        self.clock = clock or RealClock()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.weights = {
            i: torch.as_tensor(w).to(self.device, dtype)
            for i, w in weights.items()
        }
        # hash once here, not per request: the fingerprint keys the cache
        # to these parameter values (shared caches stay collision-free)
        self._weights_fp = {
            i: weights_fingerprint(w) for i, w in self.weights.items()
        }
        self._plans = {p.layer: p for p in plan.layers}
        self._shapes: set = set()  # (input shape, ragged) keys served
        self.calls = 0  # batches served through __call__
        self.images = 0  # batch rows served (padding rows included)

    @property
    def compile_count(self) -> int:
        """Distinct (input shape, ragged) programs served -- the count
        bucketing bounds (the reference package compiles one program per
        key; this eager executor compiles none)."""
        return len(self._shapes)

    def compiles_by_bucket(self) -> Dict[int, int]:
        """Program count per spatial bucket (input H)."""
        out: Dict[int, int] = {}
        for shape, _ in self._shapes:
            out[shape[1]] = out.get(shape[1], 0) + 1
        return out

    def cache_keys(self) -> list:
        """Every `KernelCache` key this executor's plan can touch (one
        per transform-consuming layer).  The hot-swap path diffs the
        outgoing and incoming executors' key sets to invalidate only
        what the new program no longer needs."""
        return [
            KernelCache.key(
                self.plan.net, p, self.dtype, self._weights_fp[i]
            )
            for i, p in self._plans.items()
            if registry.get(p.algo).consumes_wt
        ]

    def stats(self) -> dict:
        """Program counts + kernel-cache counters, one dict -- the single
        source the engine and serving front-ends extend."""
        return {
            "compiled_programs": self.compile_count,
            "compiles_per_bucket": self.compiles_by_bucket(),
            "calls": self.calls,
            "images": self.images,
            "cache": self.cache.stats(),
        }

    # ------------------------------------------------------ stage runner

    def _elementwise_fn(self, ops: Tuple[EpilogueOp, ...], ws):
        """Fold bias/relu ops into a structured `registry.ElementwiseOps`
        (None when empty): still a plain ``y -> y`` callable, but fused
        algorithms can read its op list and fold the glue into their
        kernel's scatter phase instead of a separate pass."""
        if not ops:
            return None
        return registry.ElementwiseOps(
            [
                ("bias", ws[op.layer]) if op.kind == "bias" else ("relu",)
                for op in ops
            ]
        )

    def _apply_tail(
        self, x, ops: Tuple[EpilogueOp, ...], ext: _Extent, ws
    ) -> Tuple[torch.Tensor, _Extent]:
        """Pools and any post-pool elementwise ops, on assembled output.
        True dims divide the pool windows (validated at admission), so no
        window straddles the mask edge; masked stays masked garbage-free
        after the end-of-stage re-mask."""
        for op in ops:
            if op.kind == "maxpool":
                x = _maxpool(x, op.window)
                ext = ext.after_pool(op.window)
            elif op.kind == "bias":
                x = x + ws[op.layer]
            else:
                x = torch.relu(x)
        return x, ext

    def _run_single(self, stage: Stage, x, ws, wts, ext: _Extent):
        u = stage.units[0]
        aplan = u.plan.algo_plan()
        alg = registry.get(aplan.algo)
        pre, tail = _split_epilogue(u.epilogue)
        runner = alg.fuse_epilogue(aplan, self._elementwise_fn(pre, ws))
        x = runner(x, ws[u.layer], wts.get(u.layer))
        ext = ext.after_conv(aplan.spec)
        x, ext = self._apply_tail(x, tail, ext, ws)
        return ext.mask(x), ext

    def _run_fused(self, stage: Stage, x, ws, wts, ext: _Extent):
        chain: List[registry.ChainLink] = []
        cur = ext
        tail_ops: Tuple[EpilogueOp, ...] = ()
        for j, u in enumerate(stage.units):
            aplan = u.plan.algo_plan()
            nxt = cur.after_conv(aplan.spec)
            last = j == len(stage.units) - 1
            pre, tail = _split_epilogue(u.epilogue)
            if last:
                tail_ops = tail
            # elementwise glue (bias/relu) folds into the owning
            # algorithm's task loop inside the chain, exactly as in a
            # single stage; only the position-dependent extent re-mask
            # (ragged batches) runs on the assembled intermediate --
            # tile-position-aware so the next conv of the chain never
            # taps across a true-image edge
            epi = (
                (lambda y, row0, _e=nxt: _e.mask(y, row0))
                if nxt.live and not last
                else None
            )
            chain.append(
                registry.ChainLink(
                    w=ws[u.layer], wt=wts.get(u.layer), plan=aplan,
                    epilogue=epi,
                    elementwise=self._elementwise_fn(pre, ws),
                )
            )
            cur = nxt
        alg = registry.get(stage.units[0].plan.algo)
        x = alg.execute_staged(x, chain, tile_rows=stage.tile_rows)
        x, cur = self._apply_tail(x, tail_ops, cur, ws)
        return cur.mask(x), cur

    def _prologue(self, x, sizes) -> Tuple[torch.Tensor, _Extent]:
        ext = _Extent(
            sizes[:, 0] if sizes is not None else None,
            sizes[:, 1] if sizes is not None else None,
        )
        x = ext.mask(x)
        if self.program.prologue:
            x, ext = self._apply_tail(x, self.program.prologue, ext, self.weights)
            x = ext.mask(x)
        return x, ext

    # -------------------------------------------------------- public API

    def _fetch_transforms(self) -> Dict[int, torch.Tensor]:
        """Per-request cache fetch: first request per layer transforms and
        stores; later requests (any bucket) count as hits.  The cache
        itself knows (via the registry) which algorithms have nothing to
        prepare and returns None for those."""
        wts = {}
        for i, _ in self.spec.conv_layers():
            wt = self.cache.get(
                self.plan.net, self._plans[i], self.weights[i], self.dtype,
                w_fp=self._weights_fp[i],
            )
            if wt is not None:
                wts[i] = wt
        return wts

    def _prepare_call(self, x, sizes):
        x = torch.as_tensor(x).to(self.device, self.dtype)
        if x.ndim != 4:
            raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
        self.spec.infer_shapes(x.shape[1], x.shape[2], x.shape[3])  # validate
        if sizes is not None:
            sizes = torch.as_tensor(sizes).to(self.device, torch.int64)
            if tuple(sizes.shape) != (x.shape[0], 2):
                raise ValueError(
                    f"sizes shape {tuple(sizes.shape)} != ({x.shape[0]}, 2)"
                )
        return x, sizes

    def __call__(self, x, sizes=None) -> torch.Tensor:
        """Run one batch on the executor's device.

        x: (B, H, W, C); defines the bucket.  sizes: optional (B, 2)
        integer true (h, w) per sample for ragged batches -- samples are
        zeroed beyond their true extent stage by stage so padded serving
        is exact (see module docstring).
        """
        x, sizes = self._prepare_call(x, sizes)
        wts = self._fetch_transforms()
        self._shapes.add((tuple(x.shape), sizes is not None))
        self.calls += 1
        self.images += int(x.shape[0])
        x, ext = self._prologue(x, sizes)
        for stage in self.program.stages:
            run = self._run_fused if stage.fused else self._run_single
            x, ext = run(stage, x, self.weights, wts, ext)
        return x

    def profile_stages(self, x, sizes=None) -> List[Tuple[str, float]]:
        """Per-stage times (seconds), each stage run once untimed and
        then timed: with CUDA events on the card (after a synchronize),
        with the executor's clock on the CPU.  The benchmark surface;
        serving runs the stages back to back.

        Traced as a ``profile_stages`` span holding one ``stage:<label>``
        span per stage; the untimed warm call of each stage announces the
        tile engine's phases as instants inside its stage span (served
        waves announce none)."""
        x, sizes = self._prepare_call(x, sizes)
        wts = self._fetch_transforms()
        b_h, b_w, b_c = int(x.shape[1]), int(x.shape[2]), int(x.shape[3])
        x, ext = self._prologue(x, sizes)
        cuda = self.device.type == "cuda"
        rows: List[Tuple[str, float]] = []
        tr = self.tracer
        with tr.span(
            "profile_stages", CAT_PROFILE,
            net=self.plan.net, bucket=b_h, batch=int(x.shape[0]),
        ):
            for stage in self.program.stages:
                run = self._run_fused if stage.fused else self._run_single
                with tr.span(
                    f"stage:{stage.label}", CAT_STAGE,
                    stage=stage.label, fused=stage.fused,
                ):
                    with capture_tile_phases(tr, stage=stage.label):
                        run(stage, x, self.weights, wts, ext)  # warm, untimed
                    if cuda:
                        torch.cuda.synchronize(self.device)
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        y, nxt = run(stage, x, self.weights, wts, ext)
                        t1.record()
                        t1.synchronize()
                        dt = t0.elapsed_time(t1) / 1e3
                    else:
                        c0 = self.clock.now()
                        y, nxt = run(stage, x, self.weights, wts, ext)
                        dt = self.clock.now() - c0
                    rows.append((stage.label, dt))
                x, ext = y, nxt
        want = self.spec.out_shape(b_h, b_w, b_c)
        if tuple(x.shape[1:]) != want:
            raise AssertionError(
                f"profiled stage chain produced {tuple(x.shape[1:])}, net "
                f"expects {want} -- stage runner out of sync with __call__"
            )
        return rows
