// Weight-stationary fused SwiGLU decode MLP for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/decode_mlp/kernel.py::_body (the Pallas TPU
// kernel launched by decode_mlp_call):
//     y = (silu(x W1) * (x W3)) W2,   x (B, d), W1/W3 (d, f), W2 (f, d),
// with the hidden h = silu(xW1) * xW3 never written to device memory.
//
// What bounds it on this card: bytes.  At decode B is a handful of rows, so
// the 3*d*f weights are what moves (gemma3-1b: 3*1152*6912*4 B = 95.6 MB,
// 28.5 us at 3.35 TB/s).  Reaching that rate takes every SM streaming 16-byte
// loads with tens of KB in flight per SM, and no SM left idle.
//
// The TPU kernel walks d_ff blocks as a sequential grid axis and carries one
// f32 accumulator across them.  Here the d_ff columns are cut into one block
// per SM (the host passes the count), each an even share of 32-byte grains of
// the weight rows (6-7 of gemma3's 864), so the grid is one full wave and no
// sector is read by two blocks.  Per block, for up to 4 rows of x at a time
// (the rows of x are the only rows computed; B > 4 takes several passes):
//   1. each thread owns one (row slot, float4 column unit) and keeps a private
//      ring of DEPTH rows of W1 and W3 in flight with cp.async (its own ring
//      entries, so no barrier guards them); the first rows are issued before
//      x is staged in shared memory, transposed to (d, rows);
//   2. it sums x . W1 and x . W3 down its slot's rows; the slots' sums are
//      added in slot order in shared memory, h = silu(h1) * h3 stays there;
//      the first 2*DEPTH rows of W2 for step 3 are issued before that sum;
//   3. each thread owns a (slot, float4 unit of d) and sums h . W2 over its
//      slot's rows of the block's columns from the same ring; the slots are
//      added in order and the block writes its (B, d) partial.
// A second kernel sums the partials over the blocks in a fixed order, 32
// strided block ranges in parallel per output unit (each a handful of loads,
// all in flight at once), then the 32 range sums in order.
// No float atomics: the result is bitwise the same from run to run.  With
// d or f not a multiple of 4 the same kernel runs on 1-float units.
//
// bf16 (`decode_mlp_bf16_launch`): the same kernel on bf16 x and weights,
// what the Pallas kernel computes at bf16 input (x and every weight upcast,
// f32 products and sums, h f32, the output rounded once).  A unit is 8
// values, one 16-byte load, converted to f32 in registers as it is used; x
// is staged in shared memory as f32, h stays f32 there, the partials are
// f32 and the reduction rounds each output to bf16 once.  Still bytes-bound
// at B <= 4 (FMA on the f32 units, no tensor cores): the weight bytes halve,
// so the bound does (gemma3-1b: 47.8 MB, 14.3 us).  The 8-value units double
// a thread's accumulators, so the bf16 instances cap a block at 384 threads
// (170 registers a thread) where fp32 takes 640.  bf16 takes d and f that
// are multiples of 8 and 16-byte aligned tensors only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 640;
constexpr int kMaxThreadsBf16 = 384;  // the bf16 instances' launch bound
constexpr int kMaxRows = 4;     // rows of x per pass over the weights
constexpr int kRedSlices = 32;  // block ranges summed in parallel per output unit
constexpr int kRedUnits = 8;    // output units per reduction block

// column units per grain of V-value units: blocks start and end on grains,
// 32 bytes of a weight row (one sector) for 16-byte units (4 floats, 8 bf16)
__host__ __device__ constexpr int grain(int vec) { return vec >= 4 ? 2 : 1; }

template <typename T>
struct Limits {
  static constexpr int max_threads = kMaxThreads;
};
template <>
struct Limits<bf16> {
  static constexpr int max_threads = kMaxThreadsBf16;
};

struct Geo {
  int batch, d, f;
  int n_blocks;  // d_ff blocks (rows of the partial scratch)
  int threads;   // threads per block
  int uf;        // most column units a block takes
  int slots1;    // row slots of step 2 (threads = slots1 * uf of them)
  int slots2;    // row slots of step 3
  int dut;       // threads per slot of step 3 along d's units
  int depth;     // rows of W1 and W3 each thread has in flight (2 x for W2)
};

// V floats of f32 scratch (partials, slot sums): load and store
template <int V>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void copy(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  }
  static __device__ __forceinline__ void load(float (&r)[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&r)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void copy(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
  static __device__ __forceinline__ void load(float (&r)[1], const float* p) { r[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&r)[1]) { *p = r[0]; }
};
template <>
struct Vec<8> {  // the bf16 units' f32 scratch: two float4
  static __device__ __forceinline__ void load(float (&r)[8], const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&r)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
  }
};

// a unit of V values of the element type T: the weights' cp.async into the
// ring, the ring's load into f32 registers, and the output's store
template <typename T, int V>
struct Unit {  // f32: the float units above
  static __device__ __forceinline__ void copy(T* dst, const T* src) { Vec<V>::copy(dst, src); }
  static __device__ __forceinline__ void load(float (&r)[V], const T* p) { Vec<V>::load(r, p); }
  static __device__ __forceinline__ void store(T* p, const float (&r)[V]) { Vec<V>::store(p, r); }
};
template <>
struct Unit<bf16, 8> {  // 8 bf16, one 16-byte access
  static __device__ __forceinline__ void copy(bf16* dst, const bf16* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  }
  static __device__ __forceinline__ void load(float (&r)[8], const bf16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low half holds the lower column
      r[2 * i] = __uint_as_float(w[i] << 16);
      r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&r)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared memory of one block: x^T (d, RB), the slot sums of step 2 (2 x
// slots1 x RB x uf*V), reused by step 3's (slots2 x RB x d) when slots2 > 1,
// and h (RB, uf*V), all f32; then the threads' rings (2 x depth x threads x
// V values of `esize` bytes)
__host__ __device__ inline int red_floats(const Geo& g, int rb, int vec) {
  const int red1 = 2 * g.slots1 * rb * g.uf * vec;
  const int red2 = g.slots2 > 1 ? g.slots2 * rb * g.d : 0;
  return red1 > red2 ? red1 : red2;
}
__host__ __device__ inline int smem_bytes(const Geo& g, int rb, int vec, int esize) {
  return (int)sizeof(float) * (g.d * rb + red_floats(g, rb, vec) + rb * g.uf * vec) +
         2 * g.depth * g.threads * vec * esize;
}

template <typename T, int RB, int V, int DEPTH>
__global__ void __launch_bounds__(Limits<T>::max_threads)
decode_mlp_partial(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w3, const T* __restrict__ w2,
                   float* __restrict__ part, Geo g) {
  using U = Unit<T, V>;
  extern __shared__ float4 smem4[];
  const int ufc = g.uf * V;
  float* xs = reinterpret_cast<float*>(smem4);  // (d, RB)
  float* red = xs + g.d * RB;                   // step 2 / step 3 slot sums
  float* hs = red + red_floats(g, RB, V);       // (RB, ufc)
  T* ring = reinterpret_cast<T*>(hs + RB * ufc);  // (2 * DEPTH, threads, V)

  const int tid = threadIdx.x, nthr = g.threads;
  const int units = g.f / V;
  constexpr int gran = grain(V);
  const int grains = (units + gran - 1) / gran;
  const int u_begin = (int)((long long)blockIdx.x * grains / g.n_blocks) * gran;
  const int u_end = min(units, (int)((long long)(blockIdx.x + 1) * grains / g.n_blocks) * gran);
  const int col0 = u_begin * V, ncols = (u_end - u_begin) * V;
  const int s1 = tid / g.uf, u1 = tid - s1 * g.uf;
  const bool act1 = s1 < g.slots1 && u1 < u_end - u_begin;
  const int du = g.d / V;
  const int s2 = tid / g.dut, u2 = tid - s2 * g.dut;
  const bool act2 = s2 < g.slots2 && u2 < du;
  const T* p1 = w1 + col0 + u1 * V;
  const T* p3 = w3 + col0 + u1 * V;
  const T* p2 = w2 + (size_t)col0 * g.d;
  // entry k of this thread's ring; step 2 puts W1 in entry 2k, W3 in 2k + 1
  auto entry = [&](int k) { return ring + ((size_t)k * nthr + tid) * V; };
  auto issue1 = [&](int row, int k) {
    if (act1 && row < g.d) {
      U::copy(entry(2 * k), p1 + (size_t)row * g.f);
      U::copy(entry(2 * k + 1), p3 + (size_t)row * g.f);
    }
    cp_commit();
  };

  for (int b0 = 0; b0 < g.batch; b0 += RB) {
    const int rows = min(RB, g.batch - b0);
    // step 1: the first DEPTH rows of W1 and W3 in flight while x is staged
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) issue1(s1 + k * g.slots1, k);
    __syncthreads();  // the previous pass is done with xs, red and hs
    for (int i = tid; i < g.d * RB; i += nthr) {
      const int c = i / RB, r = i - c * RB;
      xs[i] = r < rows ? to_f32(x[(size_t)(b0 + r) * g.d + c]) : 0.f;
    }
    __syncthreads();

    // step 2: this slot's share of x . W1 and x . W3 for one column unit
    float a1[RB][V], a3[RB][V];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c) a1[r][c] = a3[r][c] = 0.f;
    if (act1) {
      int k = 0;
      for (int i = s1; i < g.d; i += g.slots1) {
        cp_wait<DEPTH - 1>();  // this thread's row i has landed in entry k
        float v1[V], v3[V];
        U::load(v1, entry(2 * k));
        U::load(v3, entry(2 * k + 1));
        const float* xr = xs + i * RB;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xr[r];
#pragma unroll
          for (int c = 0; c < V; ++c) {
            a1[r][c] = fmaf(xv, v1[c], a1[r][c]);
            a3[r][c] = fmaf(xv, v3[c], a3[r][c]);
          }
        }
        issue1(i + DEPTH * g.slots1, k);  // after the FMAs have read entry k
        k = k + 1 == DEPTH ? 0 : k + 1;
      }
    }
    cp_wait<0>();

    // the first 2 * DEPTH rows of W2 in flight while h is formed; this
    // thread walks (unit u, row l) pairs, l fastest
    int iu = act2 && s2 < ncols ? u2 : du, il = s2;
    auto issue2 = [&](int k) {
      if (iu < du) {
        U::copy(entry(k), p2 + (size_t)il * g.d + iu * V);
        il += g.slots2;
        if (il >= ncols) il = s2, iu += g.dut;
      }
      cp_commit();
    };
#pragma unroll
    for (int k = 0; k < 2 * DEPTH; ++k) issue2(k);

    if (s1 < g.slots1 && u1 < g.uf) {
      float* r1 = red + (size_t)s1 * RB * ufc + u1 * V;
      float* r3 = r1 + (size_t)g.slots1 * RB * ufc;
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) {
          r1[r * ufc + c] = a1[r][c];
          r3[r * ufc + c] = a3[r][c];
        }
    }
    __syncthreads();
    for (int i = tid; i < RB * ufc; i += nthr) {
      float h1 = 0.f, h3 = 0.f;
      for (int s = 0; s < g.slots1; ++s) {
        h1 += red[(size_t)s * RB * ufc + i];
        h3 += red[(size_t)(g.slots1 + s) * RB * ufc + i];
      }
      hs[i] = (i % ufc) < ncols ? h1 * (1.f / (1.f + expf(-h1))) * h3 : 0.f;
    }
    __syncthreads();

    // step 3: this slot's share of h . W2 for one unit of d at a time
    if (act2) {
      int k = 0;
      for (int u = u2; u < du; u += g.dut) {
        float acc[RB][V];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < V; ++c) acc[r][c] = 0.f;
        for (int l = s2; l < ncols; l += g.slots2) {
          cp_wait<2 * DEPTH - 1>();
          float w[V];
          U::load(w, entry(k));
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float hv = hs[r * ufc + l];
#pragma unroll
            for (int c = 0; c < V; ++c) acc[r][c] = fmaf(hv, w[c], acc[r][c]);
          }
          issue2(k);
          k = k + 1 == 2 * DEPTH ? 0 : k + 1;
        }
        if (g.slots2 == 1) {
          for (int r = 0; r < rows; ++r)
            Vec<V>::store(part + ((size_t)blockIdx.x * g.batch + b0 + r) * g.d + u * V, acc[r]);
        } else {
#pragma unroll
          for (int r = 0; r < RB; ++r)
            Vec<V>::store(red + ((size_t)s2 * RB + r) * g.d + u * V, acc[r]);
        }
      }
    }
    cp_wait<0>();
    if (g.slots2 > 1) {
      __syncthreads();
      for (int i = tid; i < rows * g.d; i += nthr) {
        float sum = 0.f;
        for (int s = 0; s < g.slots2; ++s) sum += red[(size_t)s * RB * g.d + i];
        part[((size_t)blockIdx.x * g.batch + b0) * g.d + i] = sum;
      }
    }
  }
}

// out[i] = sum over the blocks k = 0..n_blocks-1 of part[k, i], i over the
// (B, d) outputs in V-value units: slice s sums k = s, s + 32, ... in order,
// then the 32 slice sums are added in order (and rounded to T once).
template <typename T, int V>
__global__ void __launch_bounds__(kRedSlices * kRedUnits)
decode_mlp_reduce(const float* __restrict__ part, T* __restrict__ out, int n_blocks,
                  int n_units) {
  __shared__ float sums[kRedSlices][kRedUnits * V];
  const int s = threadIdx.x / kRedUnits, uu = threadIdx.x % kRedUnits;
  const int u = blockIdx.x * kRedUnits + uu;
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  if (u < n_units) {
    const float* p = part + (size_t)u * V;
#pragma unroll 8
    for (int k = s; k < n_blocks; k += kRedSlices) {
      float w[V];
      Vec<V>::load(w, p + (size_t)k * n_units * V);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] += w[c];
    }
  }
#pragma unroll
  for (int c = 0; c < V; ++c) sums[s][uu * V + c] = acc[c];
  __syncthreads();
  if (s == 0 && u < n_units) {
    float tot[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      tot[c] = 0.f;
      for (int k = 0; k < kRedSlices; ++k) tot[c] += sums[k][uu * V + c];
    }
    Unit<T, V>::store(out + (size_t)u * V, tot);
  }
}

template <typename T, int RB, int V, int DEPTH>
int launch(const T* x, const T* w1, const T* w3, const T* w2, float* part, T* out,
           const Geo& g, int smem, cudaStream_t stream) {
  static OptIn opted;  // per device, never per launch
  if (const int err = opt_in_smem(decode_mlp_partial<T, RB, V, DEPTH>, smem, opted)) return err;
  decode_mlp_partial<T, RB, V, DEPTH><<<g.n_blocks, g.threads, smem, stream>>>(
      x, w1, w3, w2, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_units = g.batch * g.d / V;
  decode_mlp_reduce<T, V><<<(n_units + kRedUnits - 1) / kRedUnits, kRedSlices * kRedUnits, 0,
                            stream>>>(part, out, g.n_blocks, n_units);
  return (int)cudaGetLastError();
}

template <typename T, int V, int DEPTH>
int launch_rows(const T* x, const T* w1, const T* w3, const T* w2, float* part, T* out,
                const Geo& g, int rb, int smem, cudaStream_t s) {
  switch (rb) {
    case 1: return launch<T, 1, V, DEPTH>(x, w1, w3, w2, part, out, g, smem, s);
    case 2: return launch<T, 2, V, DEPTH>(x, w1, w3, w2, part, out, g, smem, s);
    case 3: return launch<T, 3, V, DEPTH>(x, w1, w3, w2, part, out, g, smem, s);
    default: return launch<T, 4, V, DEPTH>(x, w1, w3, w2, part, out, g, smem, s);
  }
}

// the checks both entry points make: a geometry that covers the work, with
// `esize`-byte values in units of `vec`, at most `max_threads` a block, and
// the shared memory of this file's layout
bool geometry_ok(const Geo& g, int vec, int rb, int smem, int esize, int max_threads) {
  const int gran = grain(vec);
  return g.batch >= 1 && g.d >= 1 && g.f >= 1 && g.d % vec == 0 && g.f % vec == 0 &&
         rb >= 1 && rb <= kMaxRows && g.n_blocks >= 1 && g.threads >= 32 &&
         g.threads <= max_threads && g.uf % gran == 0 &&
         (long long)(g.uf / gran) * g.n_blocks >= (g.f / vec + gran - 1) / gran &&
         g.slots1 >= 1 && (long long)g.slots1 * g.uf <= g.threads && g.slots2 >= 1 &&
         g.dut >= 1 && (long long)g.slots2 * g.dut <= g.threads &&
         (g.depth == 6 || g.depth == 2) && smem == smem_bytes(g, rb, vec, esize);
}

}  // namespace

// One launch's sizes and geometry, filled by the wrapper once per shape.
struct LaunchArgs {
  int batch, d, f, vec, rb, n_blocks, threads, uf, slots1, slots2, dut, depth, smem;
};

// x (batch, d), w1/w3 (d, f), w2 (f, d), part (n_blocks, batch, d) scratch,
// out (batch, d); all contiguous f32, 16-byte aligned when vec is 4 (then d
// and f are multiples of 4).  The geometry in `a` comes from the wrapper,
// which memoises it per shape; a launch whose geometry does not cover the
// work, or whose smem disagrees with this file's layout, is refused.
// Launches both kernels on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int decode_mlp_launch(const float* x, const float* w1, const float* w3,
                                 const float* w2, float* part, float* out,
                                 const LaunchArgs* a, void* stream) {
  const Geo g{a->batch,  a->d,      a->f,      a->n_blocks, a->threads,
              a->uf,     a->slots1, a->slots2, a->dut,      a->depth};
  const int vec = a->vec, rb = a->rb, smem = a->smem;
  if (!(vec == 1 || vec == 4) || !geometry_ok(g, vec, rb, smem, 4, kMaxThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    return g.depth == 6 ? launch_rows<float, 4, 6>(x, w1, w3, w2, part, out, g, rb, smem, s)
                        : launch_rows<float, 4, 2>(x, w1, w3, w2, part, out, g, rb, smem, s);
  return g.depth == 6 ? launch_rows<float, 1, 6>(x, w1, w3, w2, part, out, g, rb, smem, s)
                      : launch_rows<float, 1, 2>(x, w1, w3, w2, part, out, g, rb, smem, s);
}

// The same at bf16: x, w1, w3, w2 and out bf16, 16-byte aligned, d and f
// multiples of 8, `a->vec` 8; part f32.  The geometry's threads are at most
// 384 (`kMaxThreadsBf16`).
extern "C" int decode_mlp_bf16_launch(const bf16* x, const bf16* w1, const bf16* w3,
                                      const bf16* w2, float* part, bf16* out,
                                      const LaunchArgs* a, void* stream) {
  const Geo g{a->batch,  a->d,      a->f,      a->n_blocks, a->threads,
              a->uf,     a->slots1, a->slots2, a->dut,      a->depth};
  const int rb = a->rb, smem = a->smem;
  if (a->vec != 8 || !geometry_ok(g, 8, rb, smem, 2, kMaxThreadsBf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return g.depth == 6 ? launch_rows<bf16, 8, 6>(x, w1, w3, w2, part, out, g, rb, smem, s)
                      : launch_rows<bf16, 8, 2>(x, w1, w3, w2, part, out, g, rb, smem, s);
}
