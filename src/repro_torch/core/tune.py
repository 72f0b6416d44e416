"""The paper's "wisdom file" (S7): measured R and block tuning, and the
roofline calibration, cached on disk.

    from repro_torch.core.tune import tuned_r, lookup_r, predict_r
    r = tuned_r(h=56, w=56, c_in=64, c_out=64)   # measures once, caches
    r = lookup_r(h=56, w=56, c_in=64, c_out=64)  # tuned R, or None
    r = predict_r(c_in=64, c_out=64)             # analytic only, no timing

The analytical bounds (core.analysis) give the feasible range;
`predict_r` picks the candidate that satisfies the R >= 2 CMR_fast lower
bound while staying within the (family-exact, `TileAlgebra`-priced)
private-memory upper bound.  Within that range `tuned_r` / `tuned_blocks`
time the tile engine at each candidate on the device and store the
winner; `lookup_r` / `lookup_blocks` read the stored entries without
measuring.  Entries are keyed by (backend, transform family, tile size,
layer geometry).  The port's backend prefix is ``torch-cuda`` or
``torch-cpu``, so one ``$REPRO_WISDOM`` file never mixes its entries
with another framework's.  `measure_calibration` stores one measured
{peak_flops, dram_bw} pair per backend under ``calib:<backend>``.

Every measurement runs on its `device`: the card unless the caller names
another, and without a card it raises (`core.device.resolve_device`);
nothing measures the CPU unless asked to.  The planners pass their
engine's device, so a plan's wisdom keys name the device it runs on.
Timing is the best (calibration) or the median (tuning) of a few runs:
CUDA events after a synchronize on the card, `time.perf_counter` on the
CPU.

Every entry point takes an optional `transform` (a `core.transforms`
Transform); the m/k keyword pair is the historical Winograd-only spelling
and resolves to `WinogradTransform(m, k)`.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import analysis, transforms
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.ioutil import atomic_write_text
from repro_torch.kernels.fused_tile.blocks import BlockConfig

_DEFAULT_WISDOM = pathlib.Path.home() / ".cache" / "repro_wisdom.json"
_CANDIDATES = (4, 8, 16, 24, 32, 48)
_WISDOM_ENV = "REPRO_WISDOM"


def _wisdom_path(wisdom_path=None) -> pathlib.Path:
    """Explicit path > $REPRO_WISDOM (the CI artifact seam) > default."""
    if wisdom_path is not None:
        return pathlib.Path(wisdom_path)
    env = os.environ.get(_WISDOM_ENV)
    return pathlib.Path(env) if env else _DEFAULT_WISDOM


def _resolve_transform(
    transform: Optional[transforms.Transform], k: int, m: int
) -> transforms.Transform:
    return (
        transform
        if transform is not None
        else transforms.WinogradTransform(m=m, k=k)
    )


def _backend(device: DeviceLike = None) -> str:
    """Wisdom key prefix: `device`'s kind, or where this process runs by
    default."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    return "torch-cuda" if cuda else "torch-cpu"


def _key(tr: transforms.Transform, h, w, c_in, c_out, device: DeviceLike = None) -> str:
    """Wisdom key: backend + transform family + tile size + geometry."""
    return (
        f"{_backend(device)}:{tr.family}:{h}x{w}x{c_in}->{c_out}"
        f":k{tr.k}:t{tr.t}"
    )


def _load(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


# Wisdom values are either a bare int R (legacy files) or a stamped entry
# {"r": int, "gen": int, "ts": float, "blocks": {...}}.  `gen` is a
# monotonic generation counter per wisdom file; `ts` is wall-clock seconds.


def _entry_r(value) -> Optional[int]:
    """R from a wisdom value; None when the entry carries only other
    dimensions (e.g. a block shape tuned before any R pass)."""
    if isinstance(value, dict):
        return int(value["r"]) if "r" in value else None
    return int(value)


def _entry_gen(value) -> int:
    return int(value.get("gen", 0)) if isinstance(value, dict) else 0


def _next_gen(wisdom: dict) -> int:
    """The generation a writer stamps: one past the file's highest."""
    return max((_entry_gen(v) for v in wisdom.values()), default=0) + 1


_WISDOM_CACHE: dict = {}  # path -> (mtime_ns, parsed wisdom)


def _load_cached(path: pathlib.Path) -> dict:
    """mtime-validated wisdom read: `lookup_r` runs on every auto-dispatch
    plan, so it must not re-read and re-parse the file per call.  An
    atomic replace by a writer bumps mtime_ns, which invalidates this
    cache."""
    try:
        stamp = path.stat().st_mtime_ns
    except OSError:
        stamp = None
    key = str(path)
    hit = _WISDOM_CACHE.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    wisdom = _load(path) if stamp is not None else {}
    _WISDOM_CACHE[key] = (stamp, wisdom)
    return wisdom


def default_hw(device: DeviceLike = None) -> analysis.HardwareModel:
    """Hardware model for `device` (default: the card when there is one):
    the H100 on CUDA, the paper's SkylakeX on the CPU."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    return analysis.H100_SXM if cuda else analysis.SKYLAKE_X


def feasible_candidates(
    c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    hw: Optional[analysis.HardwareModel] = None,
    candidates: Sequence[int] = _CANDIDATES,
) -> list:
    """Candidates within the private-memory upper bound; never empty --
    the smallest candidate survives even when the bound excludes all, so a
    degenerate geometry still plans rather than erroring.  The bound is
    family-exact: complex FFT tiles halve the feasible R."""
    hw = hw or default_hw()
    tr = _resolve_transform(transform, k, m)
    r_max = analysis.max_r_ta(hw, c_in, c_out, tr.algebra)
    feas = [r for r in candidates if r <= r_max]
    return feas or [min(candidates)]


def predict_r(
    c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    hw: Optional[analysis.HardwareModel] = None,
    candidates: Sequence[int] = _CANDIDATES,
) -> int:
    """Analytic (non-measuring) R choice: the smallest feasible candidate
    at or above the R >= 2 CMR_fast lower bound, else the largest feasible
    one."""
    hw = hw or default_hw()
    feas = feasible_candidates(
        c_in, c_out, k=k, m=m, transform=transform, hw=hw,
        candidates=candidates,
    )
    target = analysis.min_r(hw)
    at_or_above = [r for r in feas if r >= target]
    return min(at_or_above) if at_or_above else max(feas)


def lookup_r(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    wisdom_path: Optional[pathlib.Path] = None,
    device: DeviceLike = None,
) -> Optional[int]:
    """Non-measuring wisdom read: the tuned R for this transform family +
    layer geometry on `device` if a tuning pass stored one, else None.
    This is how ``algo="auto"`` benefits from the wisdom file without
    ever paying a measurement at dispatch time."""
    wisdom = _load_cached(_wisdom_path(wisdom_path))
    key = _key(_resolve_transform(transform, k, m), h, w, c_in, c_out, device)
    if key not in wisdom:
        return None
    return _entry_r(wisdom[key])


def _entry_blocks(value) -> Optional[BlockConfig]:
    if isinstance(value, dict) and "blocks" in value:
        return BlockConfig.from_wisdom(value["blocks"])
    return None


def lookup_blocks(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    wisdom_path: Optional[pathlib.Path] = None,
    device: DeviceLike = None,
) -> Optional[BlockConfig]:
    """Non-measuring read of the tuned block shape on `device`, None when
    untuned.  Like `lookup_r`, this is the dispatch-time path: planning
    consults it on every auto plan and must never pay a measurement."""
    wisdom = _load_cached(_wisdom_path(wisdom_path))
    key = _key(_resolve_transform(transform, k, m), h, w, c_in, c_out, device)
    return _entry_blocks(wisdom.get(key))


# ---------------------------------------------------------------------------
# Measuring: R and block shapes on the device, merged into stamped entries.
# ---------------------------------------------------------------------------


def _seconds(fn: Callable[[], object], device: torch.device, reps: int) -> list:
    """Seconds of `reps` calls of `fn` after one untimed call: CUDA events
    after a synchronize on the card, `time.perf_counter` on the CPU."""
    fn()
    out = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            out.append(t0.elapsed_time(t1) / 1e3)
        return out
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def _median(ts: Sequence[float]) -> float:
    return sorted(ts)[len(ts) // 2]


def _operands(tr: transforms.Transform, batch, h, w, c_in, c_out, device):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((batch, h, w, c_in)) * 0.1,
                     dtype=torch.float32, device=device)
    wk = torch.tensor(rng.standard_normal((tr.k, tr.k, c_in, c_out)) * 0.1,
                      dtype=torch.float32, device=device)
    return x, wk


def measure_r(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    batch: int = 1, candidates: Sequence[int] = _CANDIDATES, reps: int = 3,
    device: DeviceLike = None,
) -> int:
    """Time the fused conv at each feasible candidate R on `device`;
    return the fastest.  Transform-generic: the timed call is the shared
    tile engine driven by `transform` (Winograd F(m, k) by default)."""
    from repro_torch.core.pipeline import fused_tile_conv

    tr = _resolve_transform(transform, k, m)
    dev = resolve_device(device)
    x, wk = _operands(tr, batch, h, w, c_in, c_out, dev)
    best_r, best_t = None, float("inf")
    for r in feasible_candidates(
        c_in, c_out, transform=tr, hw=default_hw(dev), candidates=candidates
    ):
        t = _median(_seconds(
            lambda r=r: fused_tile_conv(x, wk, tr, pad=1, r_tiles=r), dev, reps))
        if t < best_t:
            best_r, best_t = r, t
    return best_r if best_r is not None else min(candidates)


def tuned_r(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    wisdom_path: Optional[pathlib.Path] = None,
    device: DeviceLike = None,
) -> int:
    """Cached best R for this transform family + layer geometry (measures
    on first use).  Merges into the stamped entry: a tuned block shape on
    the same key survives."""
    tr = _resolve_transform(transform, k, m)
    path = _wisdom_path(wisdom_path)
    dev = resolve_device(device)
    key = _key(tr, h, w, c_in, c_out, dev)
    hit = _load(path).get(key)
    if hit is not None and _entry_r(hit) is not None:  # blocks-only entries need an R pass
        return _entry_r(hit)
    r = measure_r(h, w, c_in, c_out, transform=tr, device=dev)
    wisdom = _load(path)  # re-read: another tuner may have written meanwhile
    entry = {"r": int(r), "gen": _next_gen(wisdom), "ts": time.time()}
    prev_blocks = _entry_blocks(wisdom.get(key))
    if prev_blocks is not None:  # merge, don't clobber, the other dimension
        entry["blocks"] = prev_blocks.to_wisdom()
    wisdom[key] = entry
    atomic_write_text(path, json.dumps(wisdom, indent=1, sort_keys=True))
    return r


def block_candidates(
    c_in: int, c_out: int,
    transform: transforms.Transform,
    hw: Optional[analysis.HardwareModel] = None,
) -> list:
    """Candidate block shapes: feasible R values crossed with the
    unchunked sweep (tpp=0) and a chunked variant (tpp=8).  The CUDA
    kernel reads only R (its blocks are independent); the matrix path on
    the CPU reads both."""
    cands = []
    for r in feasible_candidates(
        c_in, c_out, transform=transform, hw=hw, candidates=(8, 16, 24, 32)
    ):
        cands.append(BlockConfig(r=r, tasks_per_program=0))
        cands.append(BlockConfig(r=r, tasks_per_program=8))
    return cands


def measure_blocks(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    batch: int = 1,
    candidates: Optional[Sequence[BlockConfig]] = None,
    reps: int = 3,
    device: DeviceLike = None,
) -> BlockConfig:
    """Time the parametric tile engine at each candidate block shape on
    the real geometry on `device`; return the fastest.  A shape the
    engine refuses (`UnsupportedSpec`) is skipped."""
    from repro_torch.kernels import fused_tile as _ft

    tr = _resolve_transform(transform, k, m)
    dev = resolve_device(device)
    x, wk = _operands(tr, batch, h, w, c_in, c_out, dev)
    cands = list(candidates or block_candidates(c_in, c_out, tr, hw=default_hw(dev)))
    best, best_t = cands[0], float("inf")
    for blocks in cands:
        def run(blocks=blocks):
            return _ft.conv2d_fused_tile(x, wk, tr, pad=1, blocks=blocks, device=dev)

        try:
            t = _median(_seconds(run, dev, reps))
        except _ft.UnsupportedSpec:
            continue
        if t < best_t:
            best, best_t = blocks, t
    return best


def tuned_blocks(
    h: int, w: int, c_in: int, c_out: int, *, k: int = 3, m: int = 5,
    transform: Optional[transforms.Transform] = None,
    wisdom_path: Optional[pathlib.Path] = None,
    device: DeviceLike = None,
) -> BlockConfig:
    """Cached best block shape for this family + geometry (measures on
    first use).  Merges into the existing stamped entry -- a prior tuned
    R survives, and a concurrent tuner's writes are re-read before the
    atomic replace, mirroring `tuned_r`."""
    tr = _resolve_transform(transform, k, m)
    path = _wisdom_path(wisdom_path)
    dev = resolve_device(device)
    key = _key(tr, h, w, c_in, c_out, dev)
    hit = _entry_blocks(_load(path).get(key))
    if hit is not None:
        return hit
    blocks = measure_blocks(h, w, c_in, c_out, transform=tr, device=dev)
    wisdom = _load(path)  # re-read: another tuner may have written meanwhile
    prev = wisdom.get(key)
    prev_r = _entry_r(prev) if prev is not None else None
    wisdom[key] = {
        "r": prev_r if prev_r is not None else int(blocks.r),
        "blocks": blocks.to_wisdom(),
        "gen": _next_gen(wisdom),
        "ts": time.time(),
    }
    atomic_write_text(path, json.dumps(wisdom, indent=1, sort_keys=True))
    return blocks


# ---------------------------------------------------------------------------
# Roofline calibration (one-shot GEMM / stream microbenchmark).
#
# A data-sheet machine (H100_SXM) prices the roofline at rates the card
# may not reach -- a card set below its 700 W limit runs slower under
# load -- which turns `measured_over_predicted` into noise.  One measured
# {peak_flops, dram_bw} pair per backend, cached in the wisdom file under
# "calib:<backend>", anchors every roofline number to the device the run
# actually uses.
#
# The sizes are the device's own.  On the CPU they are the reference's (a
# 768^3 GEMM, a 32 MB stream).  On the card those would measure the wrong
# things: a 768^3 GEMM takes ~15 us, so launch overhead dominates, and a
# 32 MB stream fits in the H100's 50 MB L2, so it reads L2 bandwidth, not
# HBM's.  There the GEMM is n = 8192 in fp32 with TF32 off (the tile
# kernel's arithmetic) and the stream is 512 MB read + 512 MB written,
# 10x the L2.
# ---------------------------------------------------------------------------

_CALIB_PREFIX = "calib"
_CALIB_GEMM_N = {"cpu": 768, "cuda": 8192}
_CALIB_STREAM_MB = {"cpu": 32, "cuda": 512}


def _calib_key(device: DeviceLike = None) -> str:
    return f"{_CALIB_PREFIX}:{_backend(device)}"


def run_calibration(device: DeviceLike = None, *, reps: int = 5) -> dict:
    """Measure achievable {peak_flops, dram_bw} on `device`: a dense fp32
    GEMM for the compute roof, an elementwise pass over a large array (one
    read and one write per element) for the memory roof; best of `reps`
    timed calls each.  Seconds to run, cached by `measure_calibration`."""
    dev = resolve_device(device)
    kind = "cuda" if dev.type == "cuda" else "cpu"
    n = _CALIB_GEMM_N[kind]
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = (torch.randn((n, n), generator=gen) * 0.1).to(dev)
    b = (torch.randn((n, n), generator=gen) * 0.1).to(dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 FMA, not TF32 cores
    try:
        t_gemm = min(_seconds(lambda: torch.matmul(a, b), dev, reps))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    del a, b
    m = _CALIB_STREAM_MB[kind] * 2**20 // 4
    x = torch.ones((m,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    t_stream = min(_seconds(lambda: torch.mul(x, 1.0001, out=y), dev, reps))
    return {
        "peak_flops": float(2.0 * n**3 / t_gemm),
        "dram_bw": float(2.0 * 4 * m / t_stream),  # one read + one write
        "gemm_n": n,
        "stream_mb": _CALIB_STREAM_MB[kind],
    }


def lookup_calibration(
    wisdom_path: Optional[pathlib.Path] = None, device: DeviceLike = None,
) -> Optional[dict]:
    """Cached calibration for the backend, None when never run."""
    entry = _load_cached(_wisdom_path(wisdom_path)).get(_calib_key(device))
    return dict(entry) if isinstance(entry, dict) else None


def measure_calibration(
    wisdom_path: Optional[pathlib.Path] = None, *, refresh: bool = False,
    device: DeviceLike = None,
) -> dict:
    """Calibration with wisdom caching: measures once per backend per
    wisdom file, then serves the stamped cache (refresh=True re-runs)."""
    path = _wisdom_path(wisdom_path)
    dev = resolve_device(device)
    if not refresh:
        hit = lookup_calibration(path, dev)
        if hit is not None:
            return hit
    entry = run_calibration(dev)
    wisdom = _load(path)
    entry = {**entry, "gen": _next_gen(wisdom), "ts": time.time()}
    wisdom[_calib_key(dev)] = entry
    atomic_write_text(path, json.dumps(wisdom, indent=1, sort_keys=True))
    return entry
