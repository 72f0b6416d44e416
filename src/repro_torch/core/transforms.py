"""Winograd (Cook-Toom) and FFT transform construction.

Winograd F(m, r): computes m outputs of a valid 1-D correlation with an
r-tap filter from a tile of n = m + r - 1 inputs as

    y = A^T [ (G g) . (B^T d) ]            (Lavin & Gray form)

We construct the matrices exactly, over rationals, via the transpose/dual of
Toom-Cook polynomial multiplication with n-1 finite interpolation points and
one point at infinity:

  full linear convolution u = z * g (sizes m, r -> n) is exactly

      u = E^{-1} [ (Vz z) . (Vg g) ]

  where Vz[i,:] = [a_i^0 .. a_i^{m-1}]  (last row = leading-coeff / infinity),
        Vg[i,:] = [a_i^0 .. a_i^{r-1}]  (last row = leading-coeff),
        E[i,:]  = [a_i^0 .. a_i^{n-1}]  (last row = leading-coeff).

  The map z -> u for fixed g is M z with M[s, i] = g_{s-i}; its transpose
  M^T d computes (M^T d)_i = sum_k g_k d_{i+k} -- exactly the correlation.
  Transposing the Toom-Cook factorisation gives

      y = Vz^T diag(Vg g) E^{-T} d   =>   A^T = Vz^T,  G = Vg,  B^T = E^{-T}.

All arithmetic over `fractions.Fraction`, converted to float32/float64 at the
end, so the only rounding is the final representation -- the transform
matrices themselves are exact.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import ClassVar, Sequence, Tuple

import numpy as np
import torch

# Canonical interpolation-point sequence.  The ordering matters for numerical
# stability (Lavin & Gray; wincnn): small magnitudes and +/- pairs first.
_CANONICAL_POINTS: Tuple[Fraction, ...] = tuple(
    Fraction(p)
    for p in [
        0,
        1,
        -1,
        Fraction(1, 2),
        Fraction(-1, 2),
        2,
        -2,
        Fraction(1, 4),
        Fraction(-1, 4),
        4,
        -4,
        Fraction(3, 4),
        Fraction(-3, 4),
        Fraction(4, 3),
        Fraction(-4, 3),
        3,
        -3,
    ]
)


def interpolation_points(n_finite: int) -> Tuple[Fraction, ...]:
    """First `n_finite` canonical finite interpolation points."""
    if n_finite > len(_CANONICAL_POINTS):
        raise ValueError(
            f"need {n_finite} interpolation points, have "
            f"{len(_CANONICAL_POINTS)} canonical ones"
        )
    return _CANONICAL_POINTS[:n_finite]


def _vandermonde(points: Sequence[Fraction], width: int) -> list[list[Fraction]]:
    """Rows [a^0 .. a^{width-1}] per finite point, plus the infinity row."""
    rows = [[p ** j for j in range(width)] for p in points]
    rows.append([Fraction(0)] * (width - 1) + [Fraction(1)])
    return rows


def _invert_exact(mat: list[list[Fraction]]) -> list[list[Fraction]]:
    """Exact Gauss-Jordan inverse over Fractions."""
    n = len(mat)
    aug = [row[:] + [Fraction(int(i == j)) for j in range(n)] for i, row in enumerate(mat)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r][col] != 0), None)
        if pivot is None:
            raise ValueError("singular interpolation matrix (repeated points?)")
        aug[col], aug[pivot] = aug[pivot], aug[col]
        inv_p = Fraction(1) / aug[col][col]
        aug[col] = [v * inv_p for v in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] != 0:
                f = aug[r][col]
                aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


@functools.lru_cache(maxsize=None)
def winograd_matrices_exact(m: int, r: int):
    """Exact Fraction-valued (A^T, G, B^T) for F(m, r). Shapes (m,n),(n,r),(n,n)."""
    if m < 1 or r < 1:
        raise ValueError("m and r must be positive")
    n = m + r - 1
    if n == 1:  # degenerate 1x1 "conv"
        one = [[Fraction(1)]]
        return one, one, one
    pts = interpolation_points(n - 1)
    vz = _vandermonde(pts, m)  # n x m
    vg = _vandermonde(pts, r)  # n x r
    ev = _vandermonde(pts, n)  # n x n
    ev_inv = _invert_exact(ev)
    at = [[vz[j][i] for j in range(n)] for i in range(m)]  # Vz^T: m x n
    bt = [[ev_inv[j][i] for j in range(n)] for i in range(n)]  # E^{-T}: n x n
    return at, vg, bt


def _to_np(mat, dtype) -> np.ndarray:
    return np.array([[float(v) for v in row] for row in mat], dtype=dtype)


@functools.lru_cache(maxsize=None)
def winograd_matrices(m: int, r: int, dtype=np.float32):
    """(A^T, G, B^T) for F(m, r) as numpy arrays.

    A^T: (m, n)   output (inverse) transform
    G  : (n, r)   kernel transform
    B^T: (n, n)   input transform,  n = m + r - 1 (the tile size T)
    """
    at, g, bt = winograd_matrices_exact(m, r)
    return _to_np(at, dtype), _to_np(g, dtype), _to_np(bt, dtype)


# ---------------------------------------------------------------------------
# FFT transforms.  For tile size T, cross-correlation with a K-tap kernel is
# computed via the correlation theorem on a T-point (r)FFT:
#     y = irfft( rfft(d) * conj(rfft(g, n=T)) )[0 : T-K+1]
# The wrap-around of the circular correlation only contaminates the last K-1
# outputs, which the OLA tiling discards.  The transformed-kernel tensor is
# complex with T/2+1 frequencies per axis -- the paper's "conjugate
# anti-symmetric" ~2x saving falls out of using rfft directly.
# ---------------------------------------------------------------------------


def fft_num_freqs(t: int) -> int:
    return t // 2 + 1


# ---------------------------------------------------------------------------
# The Transform protocol.
#
# The paper's task pipeline -- gather R tiles, forward-transform, channel-mix
# against stationary right-hand matrices, inverse-transform, scatter -- is
# transform-agnostic: only the basis change and the domain the channel mix
# runs in differ between Winograd and FFT.  A `Transform` packages exactly
# that difference, so one tile engine (repro_torch.core.pipeline) serves every
# family, and the cost model sees each family through its `TileAlgebra`.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileAlgebra:
    """Cost/working-set terms of one transform family at one tile size.

    Everything the roofline model (core.analysis), the R-tuner (core.tune)
    and the fusion-group planner need to reason about a transform without
    knowing its math:

      alpha          real-MAC multiplier of the channel mix in the paper's
                     FLOP accounting (1 Winograd; 2 FFT -- the complex 4x
                     folded against the rfft half-spectrum)
      domain_points  stored domain elements per tile plane (T^2 Winograd,
                     T*(T/2+1) rfft frequencies)
      elem_bytes     bytes per stored domain element (4 real, 8 complex)
      planes         real planes per domain element as the tile kernel
                     stores them (1 real family, 2 complex re/im split)
    """

    family: str
    t: int
    t_out: int
    alpha: int
    domain_points: int
    elem_bytes: int = 4
    planes: int = 1

    def kernel_matrix_bytes(self, c_in: int, c_out: int, groups: int = 1) -> int:
        """Right-hand (transformed-kernel) matrices' resident footprint."""
        return self.elem_bytes * self.domain_points * (c_in // groups) * c_out

    def flops_per_output_px(self) -> float:
        """Channel-mix FLOPs per output pixel, in units of C*C'."""
        return self.alpha * 2.0 * self.t * self.t / float(self.t_out**2)

    # ---- block-aware engine pricing -----------------------------------
    # The parametric tile kernel (kernels.fused_tile) runs every stage as
    # GEMMs: forward = (planes*S, T^2) basis matrix, mix = S batched
    # (P*C, P*C') products, inverse = (T'^2, planes*S).  These methods
    # count the MACs that kernel actually executes -- the terms the
    # calibrated roofline prices, replacing the mix-only idealization.

    def engine_macs_per_tile(
        self, c_in: int, c_out: int, groups: int = 1
    ) -> int:
        """Real MACs one input tile costs in the parametric tile kernel
        (forward basis GEMM + channel mix + inverse basis GEMM)."""
        p, s = self.planes, self.domain_points
        fwd = p * s * self.t * self.t * c_in
        mix = s * (p * c_in) * (p * c_out) // groups
        inv = self.t_out * self.t_out * p * s * c_out
        return fwd + mix + inv

    def engine_flops(
        self, out_h: int, out_w: int, c_in: int, c_out: int,
        groups: int = 1, batch: int = 1,
    ) -> int:
        """Total engine FLOPs covering an out_h x out_w output (the
        stride-1 tile grid -- strided convs decimate afterwards, so the
        full grid is the honest charge)."""
        n_tiles = -(-out_h // self.t_out) * (-(-out_w // self.t_out))
        return (
            2 * batch * n_tiles
            * self.engine_macs_per_tile(c_in, c_out, groups)
        )


@dataclasses.dataclass(frozen=True)
class TileKernelSpec:
    """One transform family compiled to the parametric tile kernel's
    matrix form (kernels.fused_tile).

    Every family's forward/inverse basis change is expressed as ONE real
    matrix acting on flattened (T*T) tiles -- the Kronecker (row (x)
    column) form -- with complex domains split into stacked re/im row
    planes.  The kernel then runs the identical gather -> fwd GEMM ->
    batched mix -> inv GEMM -> scatter program for Winograd and FFT:

      fwd  (planes*s_mix, T*T)      U_plane-major = fwd @ d_flat
      inv  (t_out*t_out, planes*s_mix)
      mix  s_mix batched (planes*C, planes*C') real GEMMs against
           `pack_rhs(wt)` -- the complex product spelled as the
           [[Wr, Wi], [-Wi, Wr]] real block form when planes == 2.

    Rows of `fwd` (and columns of `inv`) are PLANE-MAJOR: all s_mix
    re-rows, then all s_mix im-rows.  `pack_rhs` packs the cached
    family-native transformed kernels into the matching layout.
    """

    family: str
    t: int
    t_out: int
    k: int
    planes: int
    s_mix: int
    fwd: np.ndarray
    inv: np.ndarray

    def __post_init__(self):
        assert self.fwd.shape == (self.planes * self.s_mix, self.t * self.t)
        assert self.inv.shape == (
            self.t_out * self.t_out, self.planes * self.s_mix,
        )

    def pack_rhs(self, wt: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """Family-native transformed kernels -> (s_mix, groups,
        planes*C/g, planes*C'/g) real mix matrices, group-blocked,
        contiguous f32.

        Winograd wt: (S, C/g, C') real.  FFT wt: (T, F, C/g, C') complex
        (conjugated in `kernel_transform`); the complex channel mix
        U @ W becomes the real block form with plane-major channels.
        """
        s, g = self.s_mix, groups
        w3 = wt.reshape(s, wt.shape[-2], wt.shape[-1])
        if self.planes == 1:
            cg, c_out = w3.shape[1], w3.shape[2]
            return (
                w3.reshape(s, cg, g, c_out // g)
                .permute(0, 2, 1, 3)
                .to(torch.float32)
                .contiguous()
            )
        wr = w3.real.to(torch.float32)
        wi = w3.imag.to(torch.float32)
        blk = torch.cat(
            [torch.cat([wr, wi], dim=-1), torch.cat([-wi, wr], dim=-1)],
            dim=-2,
        )  # (s, 2*C/g, 2*C') plane-major both sides
        # group-block the columns *within* each plane: blk columns run
        # (plane, group, cgo) but each group's mix output must be
        # (plane, cgo) plane-major, matching the left-hand layout
        cg2, cgo = blk.shape[1], w3.shape[2] // g
        return (
            blk.reshape(s, cg2, 2, g, cgo)
            .permute(0, 3, 1, 2, 4)
            .reshape(s, g, cg2, 2 * cgo)
            .contiguous()
        )

    def macs_per_tile(self, c_in: int, c_out: int, groups: int = 1) -> int:
        p, s = self.planes, self.s_mix
        return (
            p * s * self.t * self.t * c_in
            + s * (p * c_in) * (p * c_out) // groups
            + self.t_out * self.t_out * p * s * c_out
        )


@functools.lru_cache(maxsize=None)
def _winograd_kernel_spec(m: int, k: int) -> TileKernelSpec:
    at, _, bt = winograd_matrices(m, k)
    t = m + k - 1
    return TileKernelSpec(
        family="winograd", t=t, t_out=m, k=k, planes=1, s_mix=t * t,
        fwd=np.kron(bt, bt).astype(np.float32),
        inv=np.kron(at, at).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _fft_kernel_spec(t: int, k: int) -> TileKernelSpec:
    """rfft2 as explicit DFT GEMMs (the tile kernel's GEMM spelling).

    Forward: U[x, f] = sum_{i,j} F[x,i] F[f,j] d[i,j] over the rfft
    half-spectrum f < F = T//2+1.  Inverse (irfft2 + crop, real part
    only): y[a,b] = Re( sum_{x,f} Grow[a,x] c_f Gcol[b,f] M[x,f] ) with
    c_f the hermitian doubling weights (1 at DC/Nyquist, 2 elsewhere).
    The kernel_transform wt already carries the correlation conjugate.
    """
    f = fft_num_freqs(t)
    t_out = t - k + 1
    ii = np.arange(t)
    dft = np.exp(-2j * np.pi * np.outer(ii, ii) / t)  # (T, T)
    kc = np.einsum("xi,fj->xfij", dft, dft[:f]).reshape(t * f, t * t)
    fwd = np.concatenate([kc.real, kc.imag], axis=0)
    grow = np.exp(2j * np.pi * np.outer(ii, ii) / t) / t
    cf = np.full(f, 2.0)
    cf[0] = 1.0
    if t % 2 == 0:
        cf[-1] = 1.0
    gcol = (np.exp(2j * np.pi * np.outer(ii, ii[:f]) / t) / t) * cf[None, :]
    kic = np.einsum(
        "ax,bf->abxf", grow[:t_out], gcol[:t_out]
    ).reshape(t_out * t_out, t * f)
    inv = np.concatenate([kic.real, -kic.imag], axis=1)
    return TileKernelSpec(
        family="fft", t=t, t_out=t_out, k=k, planes=2, s_mix=t * f,
        fwd=fwd.astype(np.float32), inv=inv.astype(np.float32),
    )


class Transform:
    """One transform family's basis change, as the tile engine drives it.

    `kernel_spec` lowers the family to the tile engine's matrix form
    (`TileKernelSpec`: forward/inverse basis matrices and the mix
    layout); `kernel_transform` is the ahead-of-time HWIO -> right-hand
    matrix step whose output the kernel cache stores; `algebra` feeds
    the cost model.  `forward` / `multiply` / `inverse` are the family's
    own spelling of the same three steps, in the input's dtype (f64
    included): tiles flow (N, T, T, C) -> forward -> domain -> multiply
    (channel mix against `kernel_transform`'s matrices) -> inverse ->
    (N, T', T', C').  The interpreting task scan
    (`pipeline.scan_tile_conv`) runs them.
    """

    family: ClassVar[str] = ""

    t: int
    k: int

    def kernel_spec(self) -> TileKernelSpec:
        raise NotImplementedError

    @property
    def t_out(self) -> int:
        return self.t - self.k + 1

    @property
    def algebra(self) -> TileAlgebra:
        raise NotImplementedError

    def kernel_transform(self, w: torch.Tensor) -> torch.Tensor:
        """HWIO kernels -> right-hand matrices (the ahead-of-time step)."""
        raise NotImplementedError

    def forward(self, tiles: torch.Tensor) -> torch.Tensor:
        """(N, T, T, C) spatial tiles -> transform-domain tiles."""
        raise NotImplementedError

    def multiply(
        self, u: torch.Tensor, wt: torch.Tensor, groups: int = 1
    ) -> torch.Tensor:
        """Channel mix in the transform domain; block-diagonal over groups."""
        raise NotImplementedError

    def inverse(self, u: torch.Tensor) -> torch.Tensor:
        """Domain tiles -> (N, T', T', C') output tiles."""
        raise NotImplementedError


def _grouped_mix(u2, wt, groups, sub):
    """Block-diagonal channel mix: u2 (N, S, C), wt (S, C/g, C') where
    output channel j belongs to group j // (C'/g).  `sub` is the einsum
    over one group's channels."""
    n, s, c = u2.shape
    c_out = wt.shape[-1]
    ug = u2.reshape(n, s, groups, c // groups)
    wg = wt.reshape(s, c // groups, groups, c_out // groups)
    return torch.einsum(sub, ug, wg).reshape(n, s, c_out)


@dataclasses.dataclass(frozen=True)
class WinogradTransform(Transform):
    """F(m, r) Cook-Toom basis: y = A^T [ (G g) . (B^T d) ] A."""

    m: int
    k: int

    family: ClassVar[str] = "winograd"

    @property
    def t(self) -> int:  # type: ignore[override]
        return self.m + self.k - 1

    @property
    def algebra(self) -> TileAlgebra:
        return TileAlgebra(
            family=self.family, t=self.t, t_out=self.m, alpha=1,
            domain_points=self.t * self.t, elem_bytes=4, planes=1,
        )

    def kernel_spec(self) -> TileKernelSpec:
        return _winograd_kernel_spec(self.m, self.k)

    def kernel_transform(self, w):
        _, g, _ = winograd_matrices(self.m, self.k)
        g = torch.as_tensor(g, dtype=w.dtype, device=w.device)
        wt = torch.einsum("xi,ijcd,yj->xycd", g, w, g)
        return wt.reshape(self.t * self.t, w.shape[2], w.shape[3])

    def _mats(self, x: torch.Tensor):
        at, _, bt = winograd_matrices(self.m, self.k)
        return (torch.as_tensor(at, dtype=x.dtype, device=x.device),
                torch.as_tensor(bt, dtype=x.dtype, device=x.device))

    def forward(self, tiles):
        _, bt = self._mats(tiles)
        return torch.einsum("xi,nijc,yj->nxyc", bt, tiles, bt)

    def multiply(self, u, wt, groups: int = 1):
        n, t = u.shape[0], self.t
        u2 = u.reshape(n, t * t, -1)
        if groups == 1:
            mm = torch.einsum("nsc,scd->nsd", u2, wt)
        else:
            mm = _grouped_mix(u2, wt, groups, "nsgc,scgd->nsgd")
        return mm.reshape(n, t, t, -1)

    def inverse(self, u):
        at, _ = self._mats(u)
        return torch.einsum("xi,nijc,yj->nxyc", at, u, at)


@dataclasses.dataclass(frozen=True)
class FFTTransform(Transform):
    """T-point rfft basis; cross-correlation via the correlation theorem.

    Computes in fp32 (fp64 for fp64 kernels): sub-fp32 kernels are
    lifted to fp32 in `kernel_transform`.
    """

    t: int
    k: int

    family: ClassVar[str] = "fft"

    @property
    def algebra(self) -> TileAlgebra:
        return TileAlgebra(
            family=self.family, t=self.t, t_out=self.t_out, alpha=2,
            domain_points=self.t * fft_num_freqs(self.t), elem_bytes=8,
            planes=2,
        )

    def kernel_spec(self) -> TileKernelSpec:
        return _fft_kernel_spec(self.t, self.k)

    def kernel_transform(self, w):
        wf = torch.fft.rfft2(self._lift(w), s=(self.t, self.t), dim=(0, 1))
        return wf.conj().resolve_conj()  # (T, F, C, C')

    @staticmethod
    def _lift(x):
        return x if x.dtype in (torch.float32, torch.float64) else x.to(torch.float32)

    def forward(self, tiles):
        return torch.fft.rfft2(self._lift(tiles), dim=(1, 2))  # (N, T, F, C)

    def multiply(self, u, wt, groups: int = 1):
        if groups == 1:
            return torch.einsum("nxfc,xfcd->nxfd", u, wt)
        n, x, f, _ = u.shape
        mm = _grouped_mix(
            u.reshape(n, x * f, -1), wt.reshape(x * f, *wt.shape[2:]),
            groups, "nsgc,scgd->nsgd",
        )
        return mm.reshape(n, x, f, -1)

    def inverse(self, u):
        y = torch.fft.irfft2(u, s=(self.t, self.t), dim=(1, 2))
        return y[:, : self.t_out, : self.t_out, :]
