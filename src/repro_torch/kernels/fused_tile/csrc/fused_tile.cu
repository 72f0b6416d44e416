// The parametric L3-fused tile kernel for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/fused_tile/kernel.py::_kernel_body (the Pallas
// TPU kernel launched by fused_tile_call).  Every transform family enters as
// data -- the (P*S, T*T) forward and (T'*T', P*S) inverse basis matrices of a
// TileKernelSpec -- so Winograd (P=1) and FFT (P=2, complex mix as the real
// block form [[Wr, Wi], [-Wi, Wr]]) run this one body.
//
// Work split.  One thread block takes R tiles (consecutive in the flattened
// (image, tile row, tile column) order, so no task is ragged but the last),
// one slab of NS output channels, and one range of the S transform points.
// grid = (ceil(tiles / R), ceil(C' / NS), splits).  The wrapper picks R, NS,
// the chunk SC and the split from the shape (kernel.py::launch_geometry) so
// that the grid covers the 132 SMs: R and the slab trade rhs reuse and
// repeated forward work against block count.
//
// Per block the S points stream through shared memory in chunks of SC,
// in s order:
//   1. forward:  U[s, r, kd] = fwd[ps, :] . patch[r, :, c] for the chunk's
//      P*SC basis rows; a thread holds 4 rows x 1-2 (tile, channel)
//      columns in registers, so each shared-memory load feeds 4-8 FMAs.
//   2. mix:      Z[s, r, col] = U[s, r, group(col)] . rhs[s, group(col), :,
//      col] over P*C/g; a thread holds 4 tiles x 1-2 columns.
//   3. inverse:  y[a, r, co] += inv[a, ps] * Z[ps, r, co], accumulated in
//      registers across chunks (a thread owns one (tile, channel) and NA
//      output pixels), then the bias/relu epilogue and the store.
// The input patches are staged once per block.  Each chunk's fwd rows and
// inv columns -- and, when the geometry says so, its rhs slice -- are
// staged with cp.async into the second of two buffers while the current
// chunk computes; otherwise the mix reads the rhs through L1 from L2,
// which leaves the shared memory for more resident blocks (the faster
// choice from 64 channels up).  Transformed tiles never leave shared
// memory or registers; the right-hand matrices come from L2 (the paper's
// shared L3), read once per block, so R sets the L2 traffic per tile.
// Three barriers per chunk.
//
// Summation order.  Every output of every GEMM is one fp32 FMA chain in the
// same k order as the plain per-element dot products: over T*T in the
// forward, over P*C/g in the mix, over s within each plane in the inverse.
// For Winograd (P=1, never split) the result is bitwise that order; for FFT
// the two planes' chains -- and, when S is split across blocks, the
// splits' pieces of each chain -- are added in a fixed order by
// tile_reduce, so the result is the same in every run.
//
// What bounds it on this card.  The work is fp32 FMAs (no tensor cores:
// TF32 would break parity with the plain version), 67 TFLOP/s, except at
// few channels, where the input and output bytes at 3.35 TB/s dominate.
// Measured, the kernel reaches 5-7 TFLOP/s at 64 channels: it is bound by
// latency, not by either peak.  Two or three blocks of 8 warps share an
// SM, too few to hide the 4-cycle FMA chains, the shared-memory loads,
// the mix's L2 reads and the three barriers of every chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMR = 4;           // register-tile rows in the forward and mix
constexpr unsigned kRelu = 15u;  // epilogue op code; 0..14 = bias row index

// Problem, launch geometry and shared-memory layout (floats), by value.
struct Geo {
  const float* xp;      // (B, H_pad, W_pad, C)
  const float* rhs;     // (S, g, P*C/g, P*C'/g)
  const float* fwd_t;   // (T*T, P*S): the forward basis, transposed
  const float* inv_t;   // (P*S, T'*T'): the inverse basis, transposed
  const float* biases;  // (n_bias, C')
  float* out;           // (B, nH*T', nW*T', C')
  float* part;          // (splits, P, tiles, T'*T', C') partial sums
  int h_pad, w_pad, c_in, c_out, t, t_out, s_mix, groups;
  int n_tiles, n_th, n_tw;
  int r, ns, sc, n_split, s_per_split;
  int ag, an;  // inverse: thread groups over output pixels, padded pixel count
  int n_ops;
  unsigned long long ep_code;
  int pst, frp, kg, kd, nc, r4;  // patch stride per tile, padded widths
  int fwd_pairs, mix_pairs;      // two columns per forward / mix item
  int off_fwd, off_inv, off_rhs, off_u, off_z;
  int sz_fwd, sz_inv, sz_rhs;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float epilogue(const Geo& g, float v, int co) {
  for (int o = 0; o < g.n_ops; ++o) {
    const unsigned code = static_cast<unsigned>((g.ep_code >> (4 * o)) & 15ull);
    v = code == kRelu ? fmaxf(v, 0.f) : v + g.biases[code * g.c_out + co];
  }
  return v;
}

__device__ __forceinline__ size_t out_index(const Geo& g, int n, int a, int co) {
  const int per_img = g.n_th * g.n_tw;
  const int b = n / per_img, ti = (n % per_img) / g.n_tw, tj = n % g.n_tw;
  const int oh = g.n_th * g.t_out, ow = g.n_tw * g.t_out;
  const int row = ti * g.t_out + a / g.t_out, col = tj * g.t_out + a % g.t_out;
  return ((static_cast<size_t>(b) * oh + row) * ow + col) * g.c_out + co;
}

// idx = row * len + u, advanced by kThreads without a division per step
struct Iter2 {
  int row, u, len, drow, du;
  __device__ explicit Iter2(int len_) : len(len_) {
    row = threadIdx.x / len;
    u = threadIdx.x % len;
    drow = kThreads / len;
    du = kThreads % len;
  }
  __device__ void next() {
    u += du;
    row += drow;
    if (u >= len) {
      u -= len;
      ++row;
    }
  }
};

// patch[r*pst + (i*T + j)*C + c] = xp[tile n0 + r, row i, col j, c]: one
// contiguous run of T*C floats per (r, i), copied 16 bytes at a time when
// C allows it.  Tiles past the last read as zeros.
__device__ void stage_patches(const Geo& g, float* patch, int n0) {
  const int per_img = g.n_th * g.n_tw, run = g.t * g.c_in;
  const bool vec = (g.c_in & 3) == 0;
  const int len = vec ? run / 4 : run;
  for (Iter2 it(len); it.row < g.r * g.t; it.next()) {
    const int r = it.row / g.t, i = it.row % g.t, n = n0 + r;
    float* d = patch + r * g.pst + i * run;
    if (n >= g.n_tiles) {
      if (vec)
        *reinterpret_cast<float4*>(d + 4 * it.u) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        d[it.u] = 0.f;
      continue;
    }
    const int b = n / per_img, ti = (n % per_img) / g.n_tw, tj = n % g.n_tw;
    const float* src = g.xp + ((static_cast<size_t>(b) * g.h_pad + ti * g.t_out + i) * g.w_pad +
                               tj * g.t_out) * g.c_in;
    if (vec)
      cp_async16(d + 4 * it.u, src + 4 * it.u);
    else
      cp_async4(d + it.u, src + it.u);
  }
}

// One chunk's operands into buffer `buf`: fwd rows as [k][j] from fwd_t,
// inv columns as [j][a] from inv_t, j = plane*SC + s - s0; the rhs slice of
// this block's slab as [s - s0][kk][col], col = plane*NS + channel - co0.
// Points past the chunk's end and padding read as zeros.
template <int P, bool STAGE_RHS>
__device__ void stage_chunk(const Geo& g, float* sm, int buf, int s0, int scv) {
  const int tt = g.t * g.t, to2 = g.t_out * g.t_out, ps_n = P * g.s_mix;
  float* fs = sm + g.off_fwd + buf * g.sz_fwd;
  for (Iter2 it(g.sc); it.row < tt * P; it.next()) {  // row = k*P + plane
    const int k = it.row / P, plane = it.row % P;
    float* d = fs + k * g.frp + plane * g.sc + it.u;
    if (it.u < scv)
      cp_async4(d, g.fwd_t + static_cast<size_t>(k) * ps_n + plane * g.s_mix + s0 + it.u);
    else
      *d = 0.f;
  }
  float* is = sm + g.off_inv + buf * g.sz_inv;
  for (Iter2 it(g.an); it.row < P * g.sc; it.next()) {  // row = j
    const int plane = it.row / g.sc, sl = it.row % g.sc;
    float* d = is + it.row * g.an + it.u;
    if (it.u < to2 && sl < scv)
      cp_async4(d, g.inv_t + static_cast<size_t>(plane * g.s_mix + s0 + sl) * to2 + it.u);
    else
      *d = 0.f;
  }
  if (!STAGE_RHS) return;
  float* rs = sm + g.off_rhs + buf * g.sz_rhs;
  const int n_el = g.sc * g.kg * g.nc, n_valid = scv * g.kg * g.nc;
  if (g.groups == 1 && g.ns == g.c_out) {
    // the slab is every channel: the chunk's slices are one contiguous run
    const float* src = g.rhs + static_cast<size_t>(s0) * g.kg * g.nc;
    if ((n_valid & 3) == 0 && ((static_cast<size_t>(s0) * g.kg * g.nc) & 3) == 0) {
      for (int v = threadIdx.x; v < n_el / 4; v += kThreads) {
        if (4 * v < n_valid)
          cp_async16(rs + 4 * v, src + 4 * v);
        else
          *reinterpret_cast<float4*>(rs + 4 * v) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int idx = (n_el & ~3) + threadIdx.x; idx < n_el; idx += kThreads) rs[idx] = 0.f;
    } else {
      for (int idx = threadIdx.x; idx < n_el; idx += kThreads) {
        if (idx < n_valid)
          cp_async4(rs + idx, src + idx);
        else
          rs[idx] = 0.f;
      }
    }
    return;
  }
  const int cgo = g.c_out / g.groups, pcgo = P * cgo;
  const int co0 = blockIdx.y * g.ns;
  if (g.groups == 1 && (g.ns & 3) == 0 && (g.c_out & 3) == 0) {
    // a slab of whole float4s: one run of NS floats per (s, kk, plane)
    const int nv = g.ns / 4;
    for (Iter2 it(nv); it.row < g.sc * g.kg * P; it.next()) {  // row = (sl*kg + kk)*P + plane
      const int plane = it.row % P, sk = it.row / P;
      const int sl = sk / g.kg, co = co0 + 4 * it.u;
      float* d = rs + sk * g.nc + plane * g.ns + 4 * it.u;
      if (sl < scv && co < g.c_out)
        cp_async16(d, g.rhs + (static_cast<size_t>(s0) * g.kg + sk) * pcgo + plane * cgo + co);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (Iter2 it(g.nc); it.row < g.sc * g.kg; it.next()) {  // row = sl*kg + kk
    const int kk = it.row % g.kg, sl = it.row / g.kg;
    const int plane = it.u / g.ns, co = co0 + it.u % g.ns;
    float* d = rs + it.row * g.nc + it.u;
    if (sl < scv && co < g.c_out) {
      const int gi = co / cgo, jn = co % cgo;
      cp_async4(d, g.rhs + (static_cast<size_t>(s0 + sl) * g.groups + gi) * g.kg * pcgo +
                       static_cast<size_t>(kk) * pcgo + plane * cgo + jn);
    } else {
      *d = 0.f;
    }
  }
}

// -- 1: forward, (P*SC, T*T) x (T*T, R*C) -> U[s][kd][r].  An item is 4
// fwd rows x CT (tile, channel) columns; `rows` of the chunk are computed
// (for P=1 only the chunk's valid points).
template <int CT>
__device__ __forceinline__ void forward(const Geo& g, const float* patch, const float* fs,
                                        float* us, int rows, int scv) {
  const int tt = g.t * g.t, c_in = g.c_in, cgi = c_in / g.groups;
  const int fq = g.r * c_in, fqc = (fq + CT - 1) / CT;
  const int items = fqc * ((rows + kMR - 1) / kMR);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int qc = it % fqc, rg = it / fqc;
    const float* x[CT];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int q = min(qc * CT + ct, fq - 1);
      x[ct] = patch + (q / c_in) * g.pst + q % c_in;
    }
    const float* f = fs + rg * kMR;
    float a[CT][kMR];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int m = 0; m < kMR; ++m) a[ct][m] = 0.f;
#pragma unroll 7
    for (int k = 0; k < tt; ++k) {
      const float4 fv = *reinterpret_cast<const float4*>(f + k * g.frp);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        const float xv = x[ct][k * c_in];
        a[ct][0] = fmaf(fv.x, xv, a[ct][0]);
        a[ct][1] = fmaf(fv.y, xv, a[ct][1]);
        a[ct][2] = fmaf(fv.z, xv, a[ct][2]);
        a[ct][3] = fmaf(fv.w, xv, a[ct][3]);
      }
    }
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int q = qc * CT + ct;
      if (q >= fq) break;
      const int r = q / c_in, c = q % c_in;
      const int kd0 = (c / cgi) * g.kg + c % cgi;
#pragma unroll
      for (int m = 0; m < kMR; ++m) {
        const int j = rg * kMR + m;
        const int plane = j / g.sc, sl = j % g.sc;
        if (j < rows && sl < scv) us[(sl * g.kd + kd0 + plane * cgi) * g.r4 + r] = a[ct][m];
      }
    }
  }
}

// -- 2: mix.  An item is 4 tiles x CT neighbouring columns of one point s
// (CT = 2 only without groups, so both columns read the same U rows).  The
// rhs comes from the staged slice, or through L1 from L2.
template <int P, bool STAGE_RHS, int CT>
__device__ __forceinline__ void mix(const Geo& g, const float* us, const float* rs, float* zs,
                                    int s0, int scv) {
  const int cgo = g.c_out / g.groups, pcgo = P * cgo;
  const int rg_n = (g.r + kMR - 1) / kMR, ncc = (g.nc + CT - 1) / CT;
  const int items = g.sc * rg_n * ncc;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int cc = it % ncc, rest = it / ncc;
    const int rg = rest % rg_n, sl = rest / rg_n;
    if (sl >= scv) continue;
    const float* b[CT];
    int gi = 0;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int col = min(cc * CT + ct, g.nc - 1);
      const int co = min(static_cast<int>(blockIdx.y) * g.ns + col % g.ns, g.c_out - 1);
      const int plane = col / g.ns;
      gi = co / cgo;
      b[ct] = STAGE_RHS ? rs + sl * g.kg * g.nc + col
                        : g.rhs + (static_cast<size_t>(s0 + sl) * g.groups + gi) * g.kg * pcgo +
                              plane * cgo + co % cgo;
    }
    const int bs = STAGE_RHS ? g.nc : pcgo;
    const float* u = us + (sl * g.kd + gi * g.kg) * g.r4 + rg * kMR;
    float a[CT][kMR];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int m = 0; m < kMR; ++m) a[ct][m] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < g.kg; ++kk) {
      const float4 uv = *reinterpret_cast<const float4*>(u + kk * g.r4);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        const float bv = STAGE_RHS ? b[ct][kk * bs] : __ldg(b[ct] + kk * bs);
        a[ct][0] = fmaf(uv.x, bv, a[ct][0]);
        a[ct][1] = fmaf(uv.y, bv, a[ct][1]);
        a[ct][2] = fmaf(uv.z, bv, a[ct][2]);
        a[ct][3] = fmaf(uv.w, bv, a[ct][3]);
      }
    }
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int col = cc * CT + ct;
      if (col >= g.nc) break;
#pragma unroll
      for (int m = 0; m < kMR; ++m) {
        const int r = rg * kMR + m;
        if (r < g.r) zs[(sl * g.r + r) * g.nc + col] = a[ct][m];
      }
    }
  }
}

template <int P, int NA, bool STAGE_RHS>
__global__ void __launch_bounds__(kThreads) fused_tile_kernel(const Geo g) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int to2 = g.t_out * g.t_out;
  const int n0 = blockIdx.x * g.r;
  const int s_begin = blockIdx.z * g.s_per_split;
  const int s_end = min(g.s_mix, s_begin + g.s_per_split);
  const int n_chunks = s_end > s_begin ? (s_end - s_begin + g.sc - 1) / g.sc : 0;
  float* patch = sm;
  float* us = sm + g.off_u;
  float* zs = sm + g.off_z;

  stage_patches(g, patch, n0);
  if (n_chunks > 0) stage_chunk<P, STAGE_RHS>(g, sm, 0, s_begin, min(g.sc, s_end - s_begin));
  cp_commit();

  // inverse layout: thread = (tile, slab channel) x group of NA pixels
  const int rc_n = g.r * g.ns;
  const int rc = tid % rc_n, ag = tid / rc_n;
  const bool inv_thread = ag < g.ag;
  const int ir = rc / g.ns, ico = rc % g.ns;
  float acc[P][NA];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[p][i] = 0.f;

  const int rows = P * g.sc;  // chunk rows of fwd, j = plane*SC + s - s0

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int s0 = s_begin + ci * g.sc, scv = min(g.sc, s_end - s0);
    // chunk ci has landed, and every thread is past chunk ci-1's inverse,
    // so its buffers may take chunk ci+1
    cp_wait<0>();
    __syncthreads();
    if (ci + 1 < n_chunks) {
      stage_chunk<P, STAGE_RHS>(g, sm, buf ^ 1, s0 + g.sc, min(g.sc, s_end - s0 - g.sc));
      cp_commit();
    }
    const float* fs = sm + g.off_fwd + buf * g.sz_fwd;
    const float* is = sm + g.off_inv + buf * g.sz_inv;
    const float* rs = sm + g.off_rhs + buf * g.sz_rhs;

    // -- 1: forward, (P*SC, T*T) x (T*T, R*C) -> U[s][kd][r]
    if (g.fwd_pairs)
      forward<2>(g, patch, fs, us, P == 1 ? scv : rows, scv);
    else
      forward<1>(g, patch, fs, us, P == 1 ? scv : rows, scv);
    __syncthreads();

    // -- 2: mix, per s: (R, P*C/g) x (P*C/g, P*NS) within each column's group
    if (g.mix_pairs)
      mix<P, STAGE_RHS, 2>(g, us, rs, zs, s0, scv);
    else
      mix<P, STAGE_RHS, 1>(g, us, rs, zs, s0, scv);
    __syncthreads();

    // -- 3: inverse, accumulated over the chunk's s in order, per plane
    if (inv_thread) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        for (int sl = 0; sl < scv; ++sl) {
          const float z = zs[(sl * g.r + ir) * g.nc + p * g.ns + ico];
          const float* iv = is + (p * g.sc + sl) * g.an + ag * NA;
#pragma unroll
          for (int i = 0; i < NA; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(iv + i);
            acc[p][i] = fmaf(v.x, z, acc[p][i]);
            acc[p][i + 1] = fmaf(v.y, z, acc[p][i + 1]);
            acc[p][i + 2] = fmaf(v.z, z, acc[p][i + 2]);
            acc[p][i + 3] = fmaf(v.w, z, acc[p][i + 3]);
          }
        }
      }
    }
  }

  const int n = n0 + ir;
  const int co = blockIdx.y * g.ns + ico;
  if (!inv_thread || n >= g.n_tiles || co >= g.c_out) return;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int a = ag * NA + i;
    if (a < to2) {
      if (g.n_split == 1) {
        float v = acc[0][i];
        if (P == 2) v += acc[P - 1][i];
        g.out[out_index(g, n, a, co)] = epilogue(g, v, co);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p)
          g.part[((static_cast<size_t>(blockIdx.z * P + p) * g.n_tiles + n) * to2 + a) *
                     g.c_out + co] = acc[p][i];
      }
    }
  }
}

// Sum the splits' partial chains in split order, plane 0 then plane 1,
// then the epilogue and the store.
template <int P>
__global__ void __launch_bounds__(kThreads) tile_reduce_kernel(const Geo g) {
  const int to2 = g.t_out * g.t_out;
  const size_t plane_el = static_cast<size_t>(g.n_tiles) * to2 * g.c_out;
  for (size_t idx = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; idx < plane_el;
       idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const int co = static_cast<int>(idx % g.c_out);
    const int a = static_cast<int>((idx / g.c_out) % to2);
    const int n = static_cast<int>(idx / (static_cast<size_t>(g.c_out) * to2));
    float v = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float s = g.part[p * plane_el + idx];
      for (int sp = 1; sp < g.n_split; ++sp) s += g.part[(sp * P + p) * plane_el + idx];
      v = p == 0 ? s : v + s;
    }
    g.out[out_index(g, n, a, co)] = epilogue(g, v, co);
  }
}

template <int P, int NA, bool STAGE_RHS>
int launch_t(const Geo& g, dim3 grid, int smem, cudaStream_t stream) {
  static OptIn opted;  // per device, never per launch
  if (const int err = opt_in_smem(fused_tile_kernel<P, NA, STAGE_RHS>, smem, opted)) return err;
  fused_tile_kernel<P, NA, STAGE_RHS><<<grid, kThreads, smem, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.n_split == 1) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(g.n_tiles) * g.t_out * g.t_out * g.c_out;
  const size_t want = (n_out + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  tile_reduce_kernel<P><<<blocks, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

int round4(int x) { return (x + 3) & ~3; }

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue when the geometry is not one the
// kernel takes or `smem_bytes` disagrees with the layout computed here.
// The caller validates shapes and allocates `out` and, when n_split > 1,
// `part` (n_split * planes * tiles * T'^2 * C' floats).
extern "C" int fused_tile_launch(
    const float* xp, const float* rhs, const float* fwd_t, const float* inv_t,
    const float* biases, float* out, float* part, int batch, int h_pad,
    int w_pad, int c_in, int c_out, int t, int t_out, int planes, int s_mix,
    int groups, int n_tiles_h, int n_tiles_w, int r, int ns, int sc,
    int n_split, int na, int stage_rhs, int n_ops, unsigned long long ep_code,
    int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (r < 1 || ns < 1 || sc < 1 || n_split < 1 || r * ns > kThreads ||
      (planes != 1 && planes != 2) || groups < 1 || c_in % groups || c_out % groups)
    return bad;
  Geo g{};
  g.xp = xp, g.rhs = rhs, g.fwd_t = fwd_t, g.inv_t = inv_t, g.biases = biases;
  g.out = out, g.part = part;
  g.h_pad = h_pad, g.w_pad = w_pad, g.c_in = c_in, g.c_out = c_out;
  g.t = t, g.t_out = t_out, g.s_mix = s_mix, g.groups = groups;
  g.n_th = n_tiles_h, g.n_tw = n_tiles_w, g.n_tiles = batch * n_tiles_h * n_tiles_w;
  g.r = r, g.ns = ns, g.sc = sc, g.n_split = n_split;
  g.s_per_split = (s_mix + n_split - 1) / n_split;
  g.ag = kThreads / (r * ns);
  g.an = g.ag * na;
  g.n_ops = n_ops, g.ep_code = ep_code;
  if (g.an < t_out * t_out) return bad;
  // shared-memory layout, floats; kernel.py::smem_bytes prices the same
  const int tt = t * t;
  // a tile's patch is padded off a multiple of 32 floats, so threads on
  // neighbouring tiles read other banks
  g.pst = round4(tt * c_in) + ((round4(tt * c_in) & 31) == 0 ? 8 : 0);
  g.frp = round4(planes * sc);
  g.kg = planes * (c_in / groups);
  g.kd = planes * c_in;
  g.nc = planes * ns;
  g.r4 = round4(r);
  g.sz_fwd = tt * g.frp;
  g.sz_inv = planes * sc * g.an;
  g.sz_rhs = stage_rhs ? round4(sc * g.kg * g.nc) : 0;
  g.off_fwd = r * g.pst;
  g.off_inv = g.off_fwd + 2 * g.sz_fwd;
  g.off_rhs = g.off_inv + 2 * g.sz_inv;
  g.off_u = g.off_rhs + 2 * g.sz_rhs;
  g.off_z = g.off_u + round4(sc * g.kd * g.r4);
  const int total = g.off_z + round4(sc * r * g.nc);
  // two columns per item where that still leaves every thread an item
  const int fwd_rows = planes * sc;
  g.fwd_pairs = ((r * c_in + 1) / 2) * ((fwd_rows + kMR - 1) / kMR) >= kThreads;
  g.mix_pairs = groups == 1 && sc * ((r + kMR - 1) / kMR) * ((g.nc + 1) / 2) >= kThreads;
  if (total * 4 != smem_bytes) return bad;

  const dim3 grid((g.n_tiles + r - 1) / r, (c_out + ns - 1) / ns, n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FT_CASE(P_, NA_)                                                 \
  if (planes == P_ && na == NA_)                                         \
    return stage_rhs ? launch_t<P_, NA_, true>(g, grid, smem_bytes, st) \
                     : launch_t<P_, NA_, false>(g, grid, smem_bytes, st);
  FT_CASE(1, 8) FT_CASE(1, 16) FT_CASE(1, 24) FT_CASE(1, 28) FT_CASE(1, 32)
  FT_CASE(2, 8) FT_CASE(2, 16) FT_CASE(2, 24) FT_CASE(2, 28) FT_CASE(2, 32)
#undef FT_CASE
  return bad;
}
