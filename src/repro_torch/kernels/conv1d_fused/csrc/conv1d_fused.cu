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

template <int V>
__device__ __forceinline__ void load_unit(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_unit(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

template <int K, int V>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    const LaunchArgs a) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int l0 = blockIdx.x * kRows;
  const long long row0 = (long long)blockIdx.z * a.seq;
  const float* xc = x + row0 * a.x_row_stride + c;
  float* oc = out + row0 * a.d + c;
  float taps[K][V], b[V];
#pragma unroll
  for (int i = 0; i < K; ++i) load_unit<V>(w + (long long)i * a.d + c, taps[i]);
  load_unit<V>(bias + c, b);
  // win[i] holds row l0 - (K-1) + i: the K-1 halo rows, then the strip;
  // rows before 0 (the causal pad) and past the end read as zero
  float win[K - 1 + kRows][V];
#pragma unroll
  for (int i = 0; i < K - 1 + kRows; ++i) {
    const int l = l0 - (K - 1) + i;
    if (l >= 0 && l < a.seq) {
      load_unit<V>(xc + l * a.x_row_stride, win[i]);
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
      store_unit<V>(oc + (long long)(l0 + j) * a.d, o);
    }
  }
}

// any K: the taps are the outer loop, acc[j] the chain of output l0 + j
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_fused_kernel_any_k(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out,
                          const LaunchArgs a) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int l0 = blockIdx.x * kRows;
  const long long row0 = (long long)blockIdx.z * a.seq;
  const float* xc = x + row0 * a.x_row_stride + c;
  float* oc = out + row0 * a.d + c;
  float acc[kRows][V];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
  for (int i = 0; i < a.k; ++i) {
    float tap[V];
    load_unit<V>(w + (long long)i * a.d + c, tap);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      // output l0 + j meets row l0 + j - (K-1) + i at tap i
      const int l = l0 + j - (a.k - 1) + i;
      float xv[V];
      if (l >= 0 && l < a.seq) {
        load_unit<V>(xc + l * a.x_row_stride, xv);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[j][v] = fmaf(xv[v], tap[v], acc[j][v]);
    }
  }
  float b[V];
  load_unit<V>(bias + c, b);
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
      store_unit<V>(oc + (long long)(l0 + j) * a.d, o);
    }
  }
}

template <int K>
void launch(const float* x, const float* w, const float* b, float* out, const LaunchArgs& a,
            cudaStream_t stream) {
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if (a.vec == 4) {
    conv1d_fused_kernel<K, 4><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  } else {
    conv1d_fused_kernel<K, 1><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  }
}

void launch_any_k(const float* x, const float* w, const float* b, float* out,
                  const LaunchArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if (a.vec == 4) {
    conv1d_fused_kernel_any_k<4><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  } else {
    conv1d_fused_kernel_any_k<1><<<grid, a.threads, 0, stream>>>(x, w, b, out, a);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (batch, seq, d) rows a->x_row_stride floats apart (channels contiguous);
// w: (k, d); b: (d,); out: (batch, seq, d) contiguous.  k >= 1.  The
// geometry in `a` comes from the wrapper, which memoises it per shape; a
// launch whose geometry does not cover the work exactly, or asks for float4
// accesses the sizes or pointers do not allow, is refused.  Launches on
// `stream`; returns cudaGetLastError() right after the launch.
extern "C" int conv1d_fused_launch(const float* x, const float* w, const float* b,
                                   float* out, const LaunchArgs* a, void* stream) {
  const long long span = (long long)a->threads * a->vec;  // channels per block
  const bool vec_ok =
      a->vec == 1 || (a->vec == 4 && a->d % 4 == 0 && a->x_row_stride % 4 == 0 && aligned16(x) &&
                      aligned16(w) && aligned16(b) && aligned16(out));
  const bool ok =
      a->batch >= 1 && a->batch <= 65535 && a->seq >= 1 && a->d >= 1 && a->k >= 1 &&
      (a->silu == 0 || a->silu == 1) && a->x_row_stride >= a->d && vec_ok &&
      a->threads >= 32 && a->threads <= kMaxThreads && a->threads % 32 == 0 &&
      a->n_strips == (a->seq + kRows - 1) / kRows && a->n_cblocks >= 1 &&
      a->n_cblocks <= 65535 && a->n_cblocks * span >= a->d && (a->n_cblocks - 1) * span < a->d;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a->k) {
    case 1: launch<1>(x, w, b, out, *a, s); break;
    case 2: launch<2>(x, w, b, out, *a, s); break;
    case 3: launch<3>(x, w, b, out, *a, s); break;
    case 4: launch<4>(x, w, b, out, *a, s); break;
    case 5: launch<5>(x, w, b, out, *a, s); break;
    case 6: launch<6>(x, w, b, out, *a, s); break;
    case 7: launch<7>(x, w, b, out, *a, s); break;
    case 8: launch<8>(x, w, b, out, *a, s); break;
    default: launch_any_k(x, w, b, out, *a, s); break;  // k > kMaxTaps
  }
  return (int)cudaGetLastError();
}
