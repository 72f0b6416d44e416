"""The paper's "wisdom file" (S7): the read side of R and block tuning.

    from repro_torch.core.tune import lookup_r, predict_r
    r = lookup_r(h=56, w=56, c_in=64, c_out=64)  # tuned R, or None
    r = predict_r(c_in=64, c_out=64)             # analytic only, no timing

The analytical bounds (core.analysis) give the feasible range;
`predict_r` picks the candidate that satisfies the R >= 2 CMR_fast lower
bound while staying within the (family-exact, `TileAlgebra`-priced)
private-memory upper bound.  `lookup_r` / `lookup_blocks` read entries a
tuning pass stored, keyed by (backend, transform family, tile size,
layer geometry).  The port's backend prefix is ``torch-cuda`` or
``torch-cpu``, so one ``$REPRO_WISDOM`` file never mixes its entries
with another framework's.  Measuring (writing) entries is not part of
this module yet.

Every entry point takes an optional `transform` (a `core.transforms`
Transform); the m/k keyword pair is the historical Winograd-only spelling
and resolves to `WinogradTransform(m, k)`.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Optional, Sequence

import torch

from repro_torch.core import analysis, transforms
from repro_torch.core.device import DeviceLike
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


def _backend() -> str:
    """Wisdom key prefix: where this process runs by default."""
    return "torch-cuda" if torch.cuda.is_available() else "torch-cpu"


def _key(tr: transforms.Transform, h, w, c_in, c_out) -> str:
    """Wisdom key: backend + transform family + tile size + geometry."""
    return (
        f"{_backend()}:{tr.family}:{h}x{w}x{c_in}->{c_out}"
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
) -> Optional[int]:
    """Non-measuring wisdom read: the tuned R for this transform family +
    layer geometry if a tuning pass stored one, else None.  This is how
    ``algo="auto"`` benefits from the wisdom file without ever paying a
    measurement at dispatch time."""
    wisdom = _load_cached(_wisdom_path(wisdom_path))
    key = _key(_resolve_transform(transform, k, m), h, w, c_in, c_out)
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
) -> Optional[BlockConfig]:
    """Non-measuring read of the tuned block shape, None when untuned.
    Like `lookup_r`, this is the dispatch-time path: planning consults it
    on every auto plan and must never pay a measurement."""
    wisdom = _load_cached(_wisdom_path(wisdom_path))
    key = _key(_resolve_transform(transform, k, m), h, w, c_in, c_out)
    return _entry_blocks(wisdom.get(key))
