// The parametric L3-fused tile kernel for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/fused_tile/kernel.py::_kernel_body (the Pallas
// TPU kernel launched by fused_tile_call).  Every transform family enters as
// data -- the (P*S, T*T) forward and (T'*T', P*S) inverse basis matrices of a
// TileKernelSpec -- so Winograd (P=1) and FFT (P=2, complex mix as the real
// block form [[Wr, Wi], [-Wi, Wr]]) run this one body.
//
// One thread block is one task: R horizontally adjacent tiles of one tile row
// of one image.  grid = (n_tiles_w / R, n_tiles_h, batch); blocks carry no
// state between them.  Per block:
//   1. forward:  u = fwd @ d for the R overlapping T x T tiles, read straight
//      from the padded input at row i*T', column (j*R + r)*T' -- the overlap
//      is never materialized in device memory.  u is scattered plane-major
//      into blocks 1..S of the shared buffer.
//   2. mix:      for s in 0..S-1, block s <- block s+1 @ rhs[s], block-
//      diagonal over groups.  Result s overwrites left-hand matrix s-1, which
//      step s-1 already consumed (the paper's S4.2 aliasing): the buffer is
//      (S+1) x R x P*max(C, C') floats instead of 2 x S x R x P*C.
//   3. inverse:  y = inv @ z, then the bias/relu epilogue on the
//      block-resident tiles, then the (T', R*T', C') store.
//
// What bounds it on this card: at the served shapes the work is fp32 FMAs
// (no tensor cores: the reference computes in fp32, and TF32 would break
// parity), so the bound is operations at 67 TFLOP/s, except at few channels
// where the input/output bytes at 3.35 TB/s dominate.  The design keeps the
// transformed tiles (T^2/T'^2 ~ 2x the activation bytes, 4x for FFT) in
// shared memory and reads the stationary right-hand matrices from L2 -- the
// paper's "shared L3" -- so device memory sees each input and output once.
// The loops are plain per-thread dot products; wgmma/TMA staging is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kRelu = 15u;  // epilogue op code; 0..14 = bias row index

// sum_k a[k*as] * b[k*bs], one sequential fp32 FMA chain in k order -- the
// order cuBLAS's fp32 GEMMs use at most of the served shapes, which keeps
// the kernel within rounding of its plain version despite the Winograd
// basis's cancellation.  (Interleaved chains would shorten the dependency
// chain; that is for the PR that makes the kernel fast.)
__device__ __forceinline__ float dot(const float* __restrict__ a, int as,
                                     const float* __restrict__ b, int bs,
                                     int n, float acc = 0.f) {
  for (int k = 0; k < n; ++k) acc = fmaf(a[k * as], b[k * bs], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads) fused_tile_kernel(
    const float* __restrict__ xp,      // (B, H_pad, W_pad, C)
    const float* __restrict__ rhs,     // (S, g, P*C/g, P*C'/g)
    const float* __restrict__ fwd,     // (P*S, T*T)
    const float* __restrict__ inv,     // (T'*T', P*S)
    const float* __restrict__ biases,  // (n_bias, C')
    float* __restrict__ out,           // (B, nH*T', nW*T', C')
    int h_pad, int w_pad, int c_in, int c_out, int t, int t_out, int planes,
    int s_mix, int groups, int r, int n_ops, unsigned long long ep_code) {
  extern __shared__ float buf[];
  const int width = planes * max(c_in, c_out);  // buffer row width
  const int blk = r * width;                     // floats per buffer block
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * t_out;           // tile row origin
  const int col0 = blockIdx.x * r * t_out;       // first tile's column origin
  const int tt = t * t;
  const int ps_n = planes * s_mix;
  const int cgi = c_in / groups, cgo = c_out / groups;
  const int out_h = h_pad - (t - t_out);
  const int out_w = w_pad - (t - t_out);

  // -- 1: forward basis GEMM, (P*S, T*T) x (T*T, R*C) -> blocks 1..S
  const float* xb = xp + (size_t)b * h_pad * w_pad * c_in;
  const int n1 = ps_n * r * c_in;
  for (int idx = threadIdx.x; idx < n1; idx += blockDim.x) {
    const int c = idx % c_in;
    const int ri = (idx / c_in) % r;
    const int ps = idx / (c_in * r);
    const float* f = fwd + (size_t)ps * tt;
    const float* x0 =
        xb + ((size_t)row0 * w_pad + col0 + ri * t_out) * c_in + c;
    float acc = 0.f;
    for (int i = 0; i < t; ++i)
      acc = dot(f + i * t, 1, x0 + (size_t)i * w_pad * c_in, c_in, t, acc);
    const int plane = ps / s_mix, s = ps % s_mix;
    const int gi = c / cgi, ci = c % cgi;
    buf[(s + 1) * blk + ri * width + gi * planes * cgi + plane * cgi + ci] =
        acc;
  }
  __syncthreads();

  // -- 2: S channel-mix GEMMs, (R, P*C/g) x (P*C/g, P*C'/g) per group;
  // result s lands on block s, the rows of left-hand matrix s-1
  const int kdim = planes * cgi, ndim = planes * cgo;
  const int ncols = groups * ndim;  // == planes * c_out
  const int n2 = r * ncols;
  for (int s = 0; s < s_mix; ++s) {
    const float* lhs = buf + (s + 1) * blk;
    float* res = buf + s * blk;
    const float* rs = rhs + (size_t)s * groups * kdim * ndim;
    for (int idx = threadIdx.x; idx < n2; idx += blockDim.x) {
      const int col = idx % ncols, ri = idx / ncols;
      const int gi = col / ndim, jn = col % ndim;
      const float* l = lhs + ri * width + gi * kdim;
      const float* rr = rs + (size_t)gi * kdim * ndim + jn;
      res[ri * width + col] = dot(l, 1, rr, ndim, kdim);
    }
    // block s+1 is overwritten by step s+1: every read of it must be done
    __syncthreads();
  }

  // -- 3: inverse basis GEMM, (T'^2, P*S) x (P*S, R*C'), epilogue, store
  const int n3 = t_out * t_out * r * c_out;
  for (int idx = threadIdx.x; idx < n3; idx += blockDim.x) {
    const int co = idx % c_out;
    const int ri = (idx / c_out) % r;
    const int a = idx / (c_out * r);
    const int gi = co / cgo, cj = co % cgo;
    const float* iv = inv + (size_t)a * ps_n;
    const float* z = buf + ri * width + gi * planes * cgo + cj;
    float acc = 0.f;
    for (int plane = 0; plane < planes; ++plane)
      acc = dot(iv + plane * s_mix, 1, z + plane * cgo, blk, s_mix, acc);
    for (int o = 0; o < n_ops; ++o) {
      const unsigned code = (unsigned)((ep_code >> (4 * o)) & 15ull);
      acc = code == kRelu ? fmaxf(acc, 0.f) : acc + biases[code * c_out + co];
    }
    const int ar = a / t_out, ac = a % t_out;
    out[(((size_t)b * out_h + row0 + ar) * out_w + col0 + ri * t_out + ac) *
            c_out + co] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch (0 on
// success).  The caller validates shapes and allocates `out`.
extern "C" int fused_tile_launch(
    const float* xp, const float* rhs, const float* fwd, const float* inv,
    const float* biases, float* out, int batch, int h_pad, int w_pad, int c_in,
    int c_out, int t, int t_out, int planes, int s_mix, int groups, int r,
    int n_ops, unsigned long long ep_code, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles_h = (h_pad - (t - t_out)) / t_out;
  const int n_tiles_w = (w_pad - (t - t_out)) / t_out;
  dim3 grid(n_tiles_w / r, n_tiles_h, batch);
  fused_tile_kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      xp, rhs, fwd, inv, biases, out, h_pad, w_pad, c_in, c_out, t, t_out,
      planes, s_mix, groups, r, n_ops, ep_code);
  return (int)cudaGetLastError();
}
