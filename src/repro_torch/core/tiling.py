"""Overlap-add (OLA) tiling for transformed convolutions.

An input image of spatial size (H, W) with layer padding p and kernel K is
covered by tiles of size T x T placed on a stride of T' = T - K + 1 (the
output tile size).  Output tiles do not overlap; input tiles overlap by K-1.
We additionally right/bottom-pad so that the tile grid covers the padded
input exactly -- padded outputs are cropped at the end.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static geometry of an OLA tiling for one conv layer."""

    h: int  # input spatial height (unpadded)
    w: int
    k: int  # kernel size (isotropic)
    pad: int  # symmetric layer padding
    t: int  # tile size T
    # derived
    t_out: int  # T' = T - K + 1
    h_out: int  # true output height = H + 2p - K + 1
    w_out: int
    n_tiles_h: int
    n_tiles_w: int
    h_pad: int  # padded input height covered by the tile grid
    w_pad: int

    @staticmethod
    def build(h: int, w: int, k: int, pad: int, t: int) -> "TilePlan":
        if t < k:
            raise ValueError(f"tile size {t} smaller than kernel {k}")
        t_out = t - k + 1
        h_out = h + 2 * pad - k + 1
        w_out = w + 2 * pad - k + 1
        if h_out <= 0 or w_out <= 0:
            raise ValueError("kernel larger than padded input")
        n_th = math.ceil(h_out / t_out)
        n_tw = math.ceil(w_out / t_out)
        # the tile grid needs n*T' + K - 1 padded-input rows/cols
        h_pad = n_th * t_out + k - 1
        w_pad = n_tw * t_out + k - 1
        return TilePlan(
            h=h, w=w, k=k, pad=pad, t=t, t_out=t_out,
            h_out=h_out, w_out=w_out,
            n_tiles_h=n_th, n_tiles_w=n_tw,
            h_pad=h_pad, w_pad=w_pad,
        )

    @property
    def tiles_per_image(self) -> int:
        return self.n_tiles_h * self.n_tiles_w

    def n_tiles(self, batch: int) -> int:
        """N_tile = B * ceil((D-K+1)/T') * ceil((W-K+1)/T')  (paper, w/ padding)."""
        return batch * self.tiles_per_image


def pad_input(x: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Pad NHWC input: `pad` on top/left, enough on bottom/right for the grid."""
    top = plan.pad
    bottom = plan.h_pad - plan.h - plan.pad
    left = plan.pad
    right = plan.w_pad - plan.w - plan.pad
    # F.pad lists the last dim first: (C lo, C hi, W lo, W hi, H lo, H hi)
    return F.pad(x, (0, 0, left, right, top, bottom))


def extract_tiles(x_padded: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(B, H_pad, W_pad, C) -> (B, nH, nW, T, T, C) overlapping input tiles.

    A pair of strided windows (`unfold`, a view) made contiguous; the
    CUDA kernel never materializes this -- it reads the overlapping
    strips in place.
    """
    b, hp, wp, c = x_padded.shape
    assert hp == plan.h_pad and wp == plan.w_pad, (x_padded.shape, plan)
    # unfold(dim, size, step) appends the window dim last
    xt = x_padded.unfold(1, plan.t, plan.t_out)  # (B, nH, W_pad, C, T)
    xt = xt.unfold(2, plan.t, plan.t_out)  # (B, nH, nW, C, T, T)
    return xt.permute(0, 1, 2, 4, 5, 3).contiguous()  # (B, nH, nW, T, T, C)


def assemble_tiles(y_tiles: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(B, nH, nW, T', T', C') -> (B, H_out, W_out, C') output assembly.

    Output tiles abut exactly (stride == size), so assembly is a transpose +
    reshape + crop; no scatter needed.
    """
    b, nh, nw, tp, tp2, c = y_tiles.shape
    assert (nh, nw, tp, tp2) == (plan.n_tiles_h, plan.n_tiles_w, plan.t_out, plan.t_out)
    y = y_tiles.permute(0, 1, 3, 2, 4, 5).reshape(
        b, nh * plan.t_out, nw * plan.t_out, c
    )
    return y[:, : plan.h_out, : plan.w_out, :]
