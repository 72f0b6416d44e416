// Depthwise causal conv1d + bias + optional SiLU for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/conv1d_fused/kernel.py::_body (the Pallas TPU
// kernel launched by conv1d_fused_call): the Mamba2 short conv and the
// registry's conv1d_fused algorithm,
//     out[b, l, c] = act(sum_{i<K} x[b, l - (K-1) + i, c] * w[i, c] + bias[c])
// with x[b, l < 0, c] = 0 (causal front pad).
//
// What bounds it on this card: bytes.  2K FLOPs per element against 8 bytes
// moved (one read, one write), so at the served shape (B=4, L=768, D=4352)
// the floor is 2*B*L*D*4 B / 3.35 TB/s = 31.9 us.  Reaching it takes 16-byte
// accesses and tens of KB of loads in flight on every SM.
//
// The TPU kernel walks L in blocks of lb rows as a sequential grid axis.
// Here a thread owns V adjacent channels (V = 4: one float4 per row, when
// D, the row stride and the pointers allow it; else V = 1) of one strip of
// kRows rows of one sequence: grid = (strips, channel blocks, B), computed
// by the host (`launch_geometry` in kernel.py; 3,456 blocks at the shape
// above).  The thread keeps its K taps and its bias in registers and issues
// the loads of the K-1 halo rows before its strip and of the strip's kRows
// rows (read-only path) before it uses any of them, so each thread has
// (K-1+kRows) x 16 B in flight; the outputs are written with streaming
// stores, since nothing reads them again in this kernel.  The halo rows are
// the only rows read twice (by their own strip and, as halo, by the next
// one).  No shared memory.  The front pad is never materialized; the input
// row stride is an argument, so a column slice of a wider activation
// (Mamba's xBC inside zxbcdt) is read in place.
//
// Tried on the card and measured slower at the served shapes: strips of
// 16-64 rows walked in groups of 8 (with and without the next group's
// loads issued ahead), 16-row groups (154 registers), a 64-register cap,
// plain stores, L2 prefetch hints on the loads; 64- and 96-thread blocks
// measured the same as 128.
//
// Each output is the same chain of float operations as in the first version
// of this kernel (acc = 0; acc = fmaf(x, w_i, acc) for i = 0..K-1 in order;
// acc += bias; silu), so the result is bitwise that of one channel per
// thread walking the whole sequence, whatever V or the strip.
//
// K 1..8 are instantiated with the window in registers.  Any larger K runs
// one instance whose tap count is a runtime argument: it keeps the strip's
// kRows accumulators in registers and walks the taps in order, reading tap
// i's weights once and the kRows rows it meets through the read-only path
// (a row is read by up to K outputs of the strip, from L1 after the first).
// Its halo (K-1 rows) may reach back over several strips; the rows before
// 0 read as zero as above.  Each output's chain of operations is the one
// above, so it agrees with the templated instances where both apply.
//
// bf16 (`conv1d_fused_bf16_launch`): the same kernels on bf16 x, w and bias,
// what the Pallas kernel computes at bf16 input -- each value upcast, the
// same f32 chain of operations (taps, bias, SiLU), the output rounded to
// bf16 once.  A thread owns 8 channels (one 16-byte load a row) where D, the
// row stride and the pointers allow it, else 1; the window is kept in f32
// registers.  Bytes bound it the same way at half the bytes: mamba2-1.3b's
// first prefill wave, 2 x 4 x 768 x 4352 x 2 B, is 16.0 us at 3.35 TB/s.
// The backward has a bf16 entry too (`conv1d_fused_bwd_bf16_launch`, below).
//
// The backward (conv1d_fused_bwd_launch) is the gradient XLA computes for
// the reference's silu(conv1d_depthwise_causal(x, w) + b): the reference
// trains through no Pallas conv, so this replaces its autodiff, not a TPU
// kernel.  For an output gradient g:
//     dpre[t] = g[t] * silu'(pre[t])   (g[t] without the SiLU)
//     dx[s]   = sum_i dpre[s + K-1-i] * w[i]
//     dw[i]   = sum_{b,t} dpre[t] * x[t - (K-1) + i],   db = sum_{b,t} dpre[t]
// It is bounded by bytes too: x and g read once, dx written once (3 x 4 B
// an element).  A thread owns V channels of one segment of kSegRows rows
// and walks it in order, with the last K rows of x and of dpre in
// registers: at row t it loads x[t] and g[t], recomputes pre[t] (the
// forward's chain of operations, so pre is bitwise the forward's), forms
// dpre[t], adds it into its dw / db sums if t is its own, and writes dx[t -
// (K-1)], whose K dpre rows it now holds.  The K-1 rows past the segment
// are walked again by the next segment (their dpre, for dx only).  dw and
// db are summed without atomics: each (sequence, segment) writes its
// partial sums to a scratch row, and a second kernel adds the rows in a
// fixed order, so the result is the same bits on every run.  K 1..8 keep
// the windows in registers; a larger K runs one instance whose windows
// live in local memory (K <= kMaxAnyKBwd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// one launch's sizes and geometry; `LaunchArgs` in kernel.py mirrors it
struct LaunchArgs {
  long long x_row_stride;  // floats between rows of x (>= d)
  int batch, seq, d, k, silu;
  int vec;        // channels per thread: 4 (float4) or 1
  int threads;    // threads per block
  int n_cblocks;  // channel blocks: n_cblocks * threads * vec >= d
  int n_strips;   // strips of kRows rows: n_strips * kRows >= seq
};

namespace {

constexpr int kMaxTaps = 8;  // K 1..8 have instances of their own
constexpr int kMaxThreads = 128;
constexpr int kRows = 8;  // rows of a strip: one thread's, all loaded before any is used

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

using bf16 = __nv_bfloat16;

// V values of type T at p, as f32 (read-only path) / f32 stored as T (streaming)
template <typename T, int V>
struct Io;
template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};
template <>
struct Io<bf16, 8> {  // one 16-byte access; the low half of a word is the lower channel
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[8]) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    const uint32_t w[4] = {(uint32_t)t.x, (uint32_t)t.y, (uint32_t)t.z, (uint32_t)t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (int)((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
                   ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16));
    __stcs(reinterpret_cast<int4*>(p), make_int4(w[0], w[1], w[2], w[3]));
  }
};
template <>
struct Io<float, 8> {  // two float4 accesses (the bf16 backward's f32 partial rows)
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
};
template <>
struct Io<bf16, 4> {  // one 8-byte access
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[4]) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    const uint32_t w[2] = {(uint32_t)t.x, (uint32_t)t.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
    int w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w[i] = (int)((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
                   ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16));
    __stcs(reinterpret_cast<int2*>(p), make_int2(w[0], w[1]));
  }
};
template <>
struct Io<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[1]) {
    v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <typename T, int K, int V>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out,
                    const LaunchArgs a) {
  using U = Io<T, V>;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int l0 = blockIdx.x * kRows;
  const long long row0 = (long long)blockIdx.z * a.seq;
  const T* xc = x + row0 * a.x_row_stride + c;
  T* oc = out + row0 * a.d + c;
  float taps[K][V], b[V];
#pragma unroll
  for (int i = 0; i < K; ++i) U::load(w + (long long)i * a.d + c, taps[i]);
  U::load(bias + c, b);
  // win[i] holds row l0 - (K-1) + i: the K-1 halo rows, then the strip;
  // rows before 0 (the causal pad) and past the end read as zero
  float win[K - 1 + kRows][V];
#pragma unroll
  for (int i = 0; i < K - 1 + kRows; ++i) {
    const int l = l0 - (K - 1) + i;
    if (l >= 0 && l < a.seq) {
      U::load(xc + l * a.x_row_stride, win[i]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) win[i][v] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (l0 + j < a.seq) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) acc = fmaf(win[j + i][v], taps[i][v], acc);
        acc += b[v];
        if (a.silu) acc = acc * (1.f / (1.f + expf(-acc)));
        o[v] = acc;
      }
      U::store(oc + (long long)(l0 + j) * a.d, o);
    }
  }
}

// any K: the taps are the outer loop, acc[j] the chain of output l0 + j
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_fused_kernel_any_k(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ bias, T* __restrict__ out,
                          const LaunchArgs a) {
  using U = Io<T, V>;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int l0 = blockIdx.x * kRows;
  const long long row0 = (long long)blockIdx.z * a.seq;
  const T* xc = x + row0 * a.x_row_stride + c;
  T* oc = out + row0 * a.d + c;
  float acc[kRows][V];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
  for (int i = 0; i < a.k; ++i) {
    float tap[V];
    U::load(w + (long long)i * a.d + c, tap);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      // output l0 + j meets row l0 + j - (K-1) + i at tap i
      const int l = l0 + j - (a.k - 1) + i;
      float xv[V];
      if (l >= 0 && l < a.seq) {
        U::load(xc + l * a.x_row_stride, xv);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = fmaf(xv[v], tap[v], acc[j][v]);
    }
  }
  float b[V];
  U::load(bias + c, b);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (l0 + j < a.seq) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float r = acc[j][v] + b[v];
        if (a.silu) r = r * (1.f / (1.f + expf(-r)));
        o[v] = r;
      }
      U::store(oc + (long long)(l0 + j) * a.d, o);
    }
  }
}

// VW: the wide unit of T (4 floats or 8 bf16, 16 bytes); a.vec is VW or 1
template <typename T, int VW, int K>
void launch(const T* x, const T* w, const T* b, T* out, const LaunchArgs& a,
            cudaStream_t stream) {
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if (a.vec == VW) {
    conv1d_fused_kernel<T, K, VW><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  } else {
    conv1d_fused_kernel<T, K, 1><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  }
}

template <typename T, int VW>
void launch_any_k(const T* x, const T* w, const T* b, T* out, const LaunchArgs& a,
                  cudaStream_t stream) {
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if (a.vec == VW) {
    conv1d_fused_kernel_any_k<T, VW><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  } else {
    conv1d_fused_kernel_any_k<T, 1><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  }
}

// the forward's checks (a geometry that covers the work exactly, wide units
// of VW values only where the sizes and pointers allow them), then the
// instance of its tap count; returns cudaGetLastError() after the launch
template <typename T, int VW>
int launch_forward(const T* x, const T* w, const T* b, T* out, const LaunchArgs* a,
                   cudaStream_t s) {
  const long long span = (long long)a->threads * a->vec;  // channels per block
  const bool vec_ok =
      a->vec == 1 || (a->vec == VW && a->d % VW == 0 && a->x_row_stride % VW == 0 &&
                      aligned16(x) && aligned16(w) && aligned16(b) && aligned16(out));
  const bool ok =
      a->batch >= 1 && a->batch <= 65535 && a->seq >= 1 && a->d >= 1 && a->k >= 1 &&
      (a->silu == 0 || a->silu == 1) && a->x_row_stride >= a->d && vec_ok &&
      a->threads >= 32 && a->threads <= kMaxThreads && a->threads % 32 == 0 &&
      a->n_strips == (a->seq + kRows - 1) / kRows && a->n_cblocks >= 1 &&
      a->n_cblocks <= 65535 && a->n_cblocks * span >= a->d && (a->n_cblocks - 1) * span < a->d;
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (a->k) {
    case 1: launch<T, VW, 1>(x, w, b, out, *a, s); break;
    case 2: launch<T, VW, 2>(x, w, b, out, *a, s); break;
    case 3: launch<T, VW, 3>(x, w, b, out, *a, s); break;
    case 4: launch<T, VW, 4>(x, w, b, out, *a, s); break;
    case 5: launch<T, VW, 5>(x, w, b, out, *a, s); break;
    case 6: launch<T, VW, 6>(x, w, b, out, *a, s); break;
    case 7: launch<T, VW, 7>(x, w, b, out, *a, s); break;
    case 8: launch<T, VW, 8>(x, w, b, out, *a, s); break;
    default: launch_any_k<T, VW>(x, w, b, out, *a, s); break;  // k > kMaxTaps
  }
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- backward

constexpr int kSegRows = 32;     // rows of a backward segment: one thread's walk
constexpr int kMaxAnyKBwd = 32;  // taps the backward's any-K instance takes

// KT > 0: K = KT, windows in registers; KT == 0: K = a.k <= kMaxAnyKBwd,
// windows in local memory.  T: the element type of x, w, bias, g and dx
// (values upcast as they load, dx rounded once as it stores); the windows,
// the sums and the partial rows are f32 at both types
template <typename T, int KT, int V>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ g,
                  T* __restrict__ dx, float* __restrict__ part, const LaunchArgs a) {
  using U = Io<T, V>;
  constexpr int KW = KT > 0 ? KT : kMaxAnyKBwd;  // window length
  const int k = KT > 0 ? KT : a.k;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int s0 = blockIdx.x * kSegRows;
  const int seg_end = min(s0 + kSegRows, a.seq);  // rows whose dpre sums here
  const long long row0 = (long long)blockIdx.z * a.seq;
  const T* xc = x + row0 * a.x_row_stride + c;
  const T* gc = g + row0 * a.d + c;
  T* dxc = dx + row0 * a.d + c;
  float taps[KW][V], b[V], xw[KW][V], dw[KW][V], dwin[KW][V], db[V];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (i < k) U::load(w + (long long)i * a.d + c, taps[i]);
#pragma unroll
    for (int v = 0; v < V; ++v) xw[i][v] = dw[i][v] = dwin[i][v] = 0.f;
  }
  U::load(bias + c, b);
#pragma unroll
  for (int v = 0; v < V; ++v) db[v] = 0.f;
  // xw[j] holds row t - (K-1) + j: before the first row, the K-1 rows
  // before the segment go into xw[1..K-1] (rows before 0 read as zero)
#pragma unroll
  for (int j = 0; j < KW - 1; ++j) {
    const int l = s0 - (k - 1) + j;
    if (j < k - 1 && l >= 0) U::load(xc + l * a.x_row_stride, xw[j + 1]);
  }
  for (int t = s0; t < seg_end + k - 1; ++t) {
#pragma unroll
    for (int j = 0; j < KW - 1; ++j) {
      if (j < k - 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) xw[j][v] = xw[j + 1][v], dwin[j][v] = dwin[j + 1][v];
      }
    }
    float dp[V];
    if (t < a.seq) {
      float gv[V];
      U::load(xc + t * a.x_row_stride, xw[k - 1]);
      U::load(gc + (long long)t * a.d, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float pre = 0.f;  // the forward's chain: acc = fmaf(x, w_i, acc), + bias
#pragma unroll
        for (int i = 0; i < KW; ++i)
          if (i < k) pre = fmaf(xw[i][v], taps[i][v], pre);
        pre += b[v];
        if (a.silu) {
          const float sg = 1.f / (1.f + expf(-pre));
          dp[v] = gv[v] * (sg * (1.f + pre * (1.f - sg)));
        } else {
          dp[v] = gv[v];
        }
      }
      if (t < seg_end) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int i = 0; i < KW; ++i)
            if (i < k) dw[i][v] = fmaf(dp[v], xw[i][v], dw[i][v]);
          db[v] += dp[v];
        }
      }
    } else {  // past the end: no gradient, no input
#pragma unroll
      for (int v = 0; v < V; ++v) xw[k - 1][v] = 0.f, dp[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) dwin[k - 1][v] = dp[v];
    const int s = t - (k - 1);  // dwin[j] holds dpre row s + j
    if (s >= s0) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i)
          if (i < k) acc = fmaf(dwin[k - 1 - i][v], taps[i][v], acc);
        o[v] = acc;
      }
      U::store(dxc + (long long)s * a.d, o);
    }
  }
  // this (sequence, segment)'s partial sums: K rows of dw, then db
  float* pc = part + (long long)(blockIdx.z * a.n_strips + blockIdx.x) * (k + 1) * a.d + c;
#pragma unroll
  for (int i = 0; i < KW; ++i)
    if (i < k) Io<float, V>::store(pc + (long long)i * a.d, dw[i]);
  Io<float, V>::store(pc + (long long)k * a.d, db);
}

// dw, db: the partial rows summed in order (row 0 first), one thread an
// element, each rounded to T once
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                         T* __restrict__ db, int n_part, int k, int d) {
  const long long n = (long long)(k + 1) * d;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int p = 0; p < n_part; ++p) acc += __ldg(part + p * n + e);
  T* out = e < (long long)k * d ? dw + e : db + (e - (long long)k * d);
  if constexpr (sizeof(T) == 4) {
    *out = acc;
  } else {
    *out = __float2bfloat16_rn(acc);
  }
}

// a.vec: 4 or 1 for fp32; 8, 4 or 1 for bf16
template <typename T, int KT>
void launch_bwd(const T* x, const T* w, const T* b, const T* g, T* dx, float* part,
                const LaunchArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if constexpr (sizeof(T) == 2) {
    if (a.vec == 8) {
      conv1d_bwd_kernel<T, KT, 8><<<grid, a.threads, 0, stream>>>(x, w, b, g, dx, part, a);
      return;
    }
  }
  if (a.vec == 4) {
    conv1d_bwd_kernel<T, KT, 4><<<grid, a.threads, 0, stream>>>(x, w, b, g, dx, part, a);
  } else {
    conv1d_bwd_kernel<T, KT, 1><<<grid, a.threads, 0, stream>>>(x, w, b, g, dx, part, a);
  }
}

// the backward's checks (as the forward's; wide units of `a->vec` values,
// VW or 4, only where the sizes and pointers allow them), the instance of
// its tap count, then the reduction; cudaGetLastError() after them
template <typename T, int VW>
int launch_backward(const T* x, const T* w, const T* b, const T* g, T* dx, T* dw, T* db,
                    float* part, const LaunchArgs* a, cudaStream_t s) {
  const long long span = (long long)a->threads * a->vec;
  const bool vec_ok =
      a->vec == 1 || ((a->vec == VW || a->vec == 4) && a->d % a->vec == 0 &&
                      a->x_row_stride % a->vec == 0 && aligned16(x) && aligned16(w) &&
                      aligned16(b) && aligned16(g) && aligned16(dx) && aligned16(part));
  const bool ok =
      a->batch >= 1 && a->batch <= 65535 && a->seq >= 1 && a->d >= 1 && a->k >= 1 &&
      a->k <= kMaxAnyKBwd && (a->silu == 0 || a->silu == 1) && a->x_row_stride >= a->d &&
      vec_ok && a->threads >= 32 && a->threads <= kMaxThreads && a->threads % 32 == 0 &&
      a->n_strips == (a->seq + kSegRows - 1) / kSegRows && a->n_cblocks >= 1 &&
      a->n_cblocks <= 65535 && a->n_cblocks * span >= a->d && (a->n_cblocks - 1) * span < a->d;
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (a->k) {
    case 1: launch_bwd<T, 1>(x, w, b, g, dx, part, *a, s); break;
    case 2: launch_bwd<T, 2>(x, w, b, g, dx, part, *a, s); break;
    case 3: launch_bwd<T, 3>(x, w, b, g, dx, part, *a, s); break;
    case 4: launch_bwd<T, 4>(x, w, b, g, dx, part, *a, s); break;
    case 5: launch_bwd<T, 5>(x, w, b, g, dx, part, *a, s); break;
    case 6: launch_bwd<T, 6>(x, w, b, g, dx, part, *a, s); break;
    case 7: launch_bwd<T, 7>(x, w, b, g, dx, part, *a, s); break;
    case 8: launch_bwd<T, 8>(x, w, b, g, dx, part, *a, s); break;
    default: launch_bwd<T, 0>(x, w, b, g, dx, part, *a, s); break;  // k > kMaxTaps
  }
  const long long n = (long long)(a->k + 1) * a->d;
  const int blocks = (int)((n + kMaxThreads - 1) / kMaxThreads);
  conv1d_bwd_reduce_kernel<T><<<blocks, kMaxThreads, 0, s>>>(
      part, dw, db, a->batch * a->n_strips, a->k, a->d);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, seq, d) rows a->x_row_stride floats apart (channels contiguous);
// w: (k, d); b: (d,); out: (batch, seq, d) contiguous.  k >= 1.  The
// geometry in `a` comes from the wrapper, which memoises it per shape; a
// launch whose geometry does not cover the work exactly, or asks for float4
// accesses the sizes or pointers do not allow, is refused.  Launches on
// `stream`; returns cudaGetLastError() right after the launch.
extern "C" int conv1d_fused_launch(const float* x, const float* w, const float* b,
                                   float* out, const LaunchArgs* a, void* stream) {
  return launch_forward<float, 4>(x, w, b, out, a, (cudaStream_t)stream);
}

// The same at bf16: x, w, b and out bf16; `a->vec` 8 (one 16-byte access:
// D and the row stride multiples of 8, the pointers 16-byte aligned) or 1.
extern "C" int conv1d_fused_bf16_launch(const bf16* x, const bf16* w, const bf16* b,
                                        bf16* out, const LaunchArgs* a, void* stream) {
  return launch_forward<bf16, 8>(x, w, b, out, a, (cudaStream_t)stream);
}

// The backward of the above for the output gradient g (batch, seq, d),
// contiguous: dx (batch, seq, d) contiguous, dw (k, d), db (d,), and
// `part`, scratch of batch * n_strips * (k + 1) * d floats.  Here
// `a->n_strips` counts segments of kSegRows rows; the rest of `a` is as
// above.  k <= kMaxAnyKBwd.  Two launches on `stream` (the segments, then
// the reduction of their partial dw / db); returns cudaGetLastError()
// after them.
extern "C" int conv1d_fused_bwd_launch(const float* x, const float* w, const float* b,
                                       const float* g, float* dx, float* dw, float* db,
                                       float* part, const LaunchArgs* a, void* stream) {
  return launch_backward<float, 4>(x, w, b, g, dx, dw, db, part, a, (cudaStream_t)stream);
}

// The same at bf16: x, w, b, g, dx, dw and db bf16, `part` f32 as above;
// `a->vec` 8 (16-byte units), 4 (8-byte units) or 1, each only where D,
// the row stride and the pointers allow it.  Each value is upcast as it
// loads; pre, silu' and every sum are f32 (the fp32 entry's operations in
// its order), and dx, dw and db are rounded to bf16 once.
extern "C" int conv1d_fused_bwd_bf16_launch(const bf16* x, const bf16* w, const bf16* b,
                                            const bf16* g, bf16* dx, bf16* dw, bf16* db,
                                            float* part, const LaunchArgs* a, void* stream) {
  return launch_backward<bf16, 8>(x, w, b, g, dx, dw, db, part, a, (cudaStream_t)stream);
}
