"""Plain oracle for the fused Winograd path: direct correlation."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *, pad: int = 0) -> torch.Tensor:
    """Direct 2-D correlation, NHWC x HWIO -> NHWC, float32 accumulation.

    Implemented as K*K shifted matmuls (no convolution library call), so
    it is an independent oracle for both the tile kernel and the
    transformed paths.
    """
    b, h, wi, c = x.shape
    k = w.shape[0]
    c_out = w.shape[3]
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)).to(torch.float32)
    h_out = h + 2 * pad - k + 1
    w_out = wi + 2 * pad - k + 1
    acc = torch.zeros((b, h_out, w_out, c_out), dtype=torch.float32, device=x.device)
    for ki in range(k):
        for kj in range(k):
            patch = xp[:, ki : ki + h_out, kj : kj + w_out, :]
            acc = acc + patch @ w[ki, kj].to(torch.float32)
    return acc.to(x.dtype)
