"""Matrix path of the parametric tile kernel: the plain PyTorch version.

The exact same math as the CUDA kernel (`csrc/fused_tile.cu`) --
forward basis GEMM, batched channel mix, inverse basis GEMM, all from
one `TileKernelSpec` -- spelled as three wide GEMMs over the whole tile
population instead of a per-task grid.  It is what a CPU tensor runs,
and the version the kernel is held against on the card.

`chunk` bounds the transform-domain working set exactly like R bounds
it in the on-chip kernel: tiles are processed in chunks of that many.
Chunk 0 (the default) runs the whole population in one sweep.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tiling, transforms


_BASIS: dict = {}  # (family, t, k, device) -> (fwd, inv) constants


def basis(
    spec: transforms.TileKernelSpec, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spec's (fwd, inv) basis matrices as f32 tensors on `device`,
    copied there once per process (they are constants of the spec)."""
    key = (spec.family, spec.t, spec.k, str(torch.device(device)))
    hit = _BASIS.get(key)
    if hit is None:
        hit = (
            torch.as_tensor(spec.fwd, device=device),
            torch.as_tensor(spec.inv, device=device),
        )
        _BASIS[key] = hit
    return hit


def _run_tiles(
    d: torch.Tensor,  # (N, T*T, C) f32 flattened spatial tiles
    rhs: torch.Tensor,  # (S, g, P*C/g, P*C'/g)
    kf: torch.Tensor,  # (P*S, T*T)
    ki: torch.Tensor,  # (T'^2, P*S)
    spec: transforms.TileKernelSpec,
    groups: int,
    epilogue,
) -> torch.Tensor:
    """One sweep: (N, T*T, C) -> (N, T', T', C') output tiles."""
    n, _, c_in = d.shape
    t, t_out, p, s = spec.t, spec.t_out, spec.planes, spec.s_mix
    cgi = c_in // groups
    c_out = rhs.shape[1] * rhs.shape[3] // p
    cgo = c_out // groups

    t1 = d.permute(1, 0, 2).reshape(t * t, n * c_in)
    u = (kf @ t1).reshape(p, s, n, groups, cgi)
    lhs = u.permute(1, 3, 2, 0, 4).reshape(s, groups, n, p * cgi)
    mm = torch.matmul(lhs, rhs)  # (S, g, N, P*C'/g)
    z = (
        mm.reshape(s, groups, n, p, cgo)
        .permute(3, 0, 2, 1, 4)
        .reshape(p * s, n * c_out)
    )
    y = (ki @ z).reshape(t_out, t_out, n, c_out).permute(2, 0, 1, 3)
    if epilogue is not None:
        # output tiles abut, so elementwise glue on tiles == on the
        # assembled output
        y = epilogue(y)
    return y


def matrix_tile_conv(
    xp: torch.Tensor,
    rhs: torch.Tensor,
    plan: tiling.TilePlan,
    spec: transforms.TileKernelSpec,
    *,
    groups: int = 1,
    epilogue=None,
    chunk: int = 0,
) -> torch.Tensor:
    """(B, H_pad, W_pad, C) padded input -> (B, H_out, W_out, C')."""
    batch = xp.shape[0]
    c_in = xp.shape[-1]
    t, t_out = spec.t, spec.t_out
    kf, ki = basis(spec, xp.device)
    tiles = tiling.extract_tiles(xp, plan)  # (B, nH, nW, T, T, C)
    n = batch * plan.tiles_per_image
    d = tiles.reshape(n, t * t, c_in).to(torch.float32)

    if chunk and chunk < n:
        y = torch.cat(
            [
                _run_tiles(blk, rhs, kf, ki, spec, groups, epilogue)
                for blk in torch.split(d, chunk)
            ]
        )
    else:
        y = _run_tiles(d, rhs, kf, ki, spec, groups, epilogue)

    c_out = y.shape[-1]
    y6 = y.reshape(
        batch, plan.n_tiles_h, plan.n_tiles_w, t_out, t_out, c_out
    )
    return tiling.assemble_tiles(y6, plan)


def staged_matrix_fns(
    plan: tiling.TilePlan,
    spec: transforms.TileKernelSpec,
    groups: int = 1,
) -> Tuple:
    """The vendor three-stage structure through the same kernel math:
    stage 1 = gather + forward basis GEMM (materializes U), stage 2 =
    packed channel mix (materializes M), stage 3 = inverse basis GEMM +
    assembly.  Each stage runs over ALL tiles -- the materializing
    baseline the fused path is measured against -- yet all three consume
    the same `TileKernelSpec` as the fused kernel.

    stage2 takes the *family-native* wt and packs it, so cached kernel
    transforms stay backend-agnostic.
    """
    t, t_out, p, s = spec.t, spec.t_out, spec.planes, spec.s_mix

    def stage1(xp):
        kf, _ = basis(spec, xp.device)
        tiles = tiling.extract_tiles(xp, plan)
        b = tiles.shape[0]
        c_in = tiles.shape[-1]
        n = b * plan.tiles_per_image
        d = tiles.reshape(n, t * t, c_in).to(torch.float32)
        u = kf @ d.permute(1, 0, 2).reshape(t * t, n * c_in)
        return u.reshape(p * s, n, c_in)  # transformed tiles, plane-major

    def stage2(u, wt):
        rhs = spec.pack_rhs(wt, groups)
        _, n, c_in = u.shape
        cgi = c_in // groups
        lhs = (
            u.reshape(p, s, n, groups, cgi)
            .permute(1, 3, 2, 0, 4)
            .reshape(s, groups, n, p * cgi)
        )
        return torch.matmul(lhs, rhs)

    def stage3(mm, batch):
        _, ki = basis(spec, mm.device)
        _, g, n, pcgo = mm.shape
        cgo = pcgo // p
        c_out = g * cgo
        z = (
            mm.reshape(s, g, n, p, cgo)
            .permute(3, 0, 2, 1, 4)
            .reshape(p * s, n * c_out)
        )
        y = (ki @ z).reshape(t_out, t_out, n, c_out).permute(2, 0, 1, 3)
        y6 = y.reshape(
            batch, plan.n_tiles_h, plan.n_tiles_w, t_out, t_out, c_out
        )
        return tiling.assemble_tiles(y6, plan)

    return stage1, stage2, stage3
