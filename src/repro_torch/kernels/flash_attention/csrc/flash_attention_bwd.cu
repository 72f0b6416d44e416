// Backward flash attention for Hopper (sm_90a), fp32 in and out, on the FMA
// units.
//
// Replaces src/repro/models/flash_attention.py::_flash_bwd (the custom VJP
// that the reference trains through): given q, k, v, the forward's output o,
// its log-sum-exp lse and dO, it computes
//     P  = exp(scale * q k^T - lse)        (masked; recomputed, never stored)
//     dV = P^T dO
//     dS = P * (dO v^T - delta),  delta = rowsum(dO * o)
//     dK = scale * dS^T q,        dQ = scale * dS k
// with the forward's masks (key j visible to query i when j < Sk, j <= i if
// causal, i - j < window if window > 0), GQA (kv head = q head // g; a kv
// head's dK and dV sum over its g q heads), and ragged Sq and Sk.
//
// What bounds it on this card: operations.  Per (q row, key) pair in the band
// it does five products of 2 * hd FLOPs (S, dP, dV, dK, dQ) -- 2.5 times the
// forward's -- plus, in this design, S and dP a second time (below).  On the
// fp32 FMA units that is 67 TFLOP/s.  This first version is simple and
// deterministic, not fast: FMA loops fed from shared memory, no tensor cores,
// no TMA, no overlap of loads with compute.
//
// Design: three launches on the caller's stream, and no atomics, so every
// output element is summed by one thread in one fixed order and two runs are
// bitwise equal.
//   1. delta: one warp per (batch, q head, row), rowsum(dO * o) into scratch
//      the wrapper allocates.
//   2. dK, dV: one block per (batch, kv head, block of 32 keys).  K and V stay
//      in shared memory; the block walks the g q heads of its group and, for
//      each, the 32-row q blocks in the band (the forward's band skip read
//      from the key side).  dK and dV accumulate in registers.
//   3. dQ: one block per (batch, q head, block of 32 q rows).  q and dO stay
//      in shared memory; the block walks the kv blocks in the band, and dQ
//      accumulates in registers.  It recomputes S and dP (the price of no
//      atomics).
// Each step computes the 32 x 32 tiles S = q k^T and dP = dO v^T (a thread
// owns 2 x 2 entries of each, float4 loads along hd), turns them into P and
// dS in shared memory, then accumulates P^T dO / dS^T q (or dS k): a thread
// owns 4 rows x ceil(hd / 32) columns, column d = lane + 32 i, so the loads
// along hd are conflict-free and the row operands are broadcasts.  Shared
// memory at hd 256: four 32 x 260 tiles and two 32 x 33 tiles, 141,824 B.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kB = 32;  // q rows per q block and keys per kv block

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

template <int HD>
struct Cfg {
  static_assert(HD % 16 == 0, "the head dim must be a multiple of 16");
  static constexpr int LD = HD + 4;          // padded tile row, floats (16-byte rows)
  static constexpr int NC = (HD + 31) / 32;  // accumulator columns per thread
  static constexpr int LDP = kB + 1;         // P / dS row
  static constexpr int kTile = kB * LD;
  static constexpr int smem = (int)sizeof(float) * (4 * kTile + 2 * kB * LDP + 2 * kB);
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past Sq / Sk)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [r0, r0 + kB) of a (rows, HD) tensor at `base` with row stride `rs`
// into a (kB, LD) tile; rows at or past `n` are zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs,
                                          int r0, int n) {
  constexpr int LD = Cfg<HD>::LD;
  for (int idx = threadIdx.x; idx < kB * HD / 4; idx += kThreads) {
    const int r = idx / (HD / 4), c4 = idx - r * (HD / 4);
    const bool ok = r0 + r < n;
    cp_async16(tile + r * LD + 4 * c4, base + (ok ? r0 + r : 0) * rs + 4 * c4, ok);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 32 x 32 tile of q rows [q0, q0 + kB) against keys [k0, k0 + kB):
// S = q k^T and dP = dO v^T from the tiles in shared memory, then
// P = exp(scale * S - lse) where the mask allows (else 0) and
// dS = P * (dP - delta), stored as (q row, key) with row stride LDP.
// P is stored only when `psh` is not null.
template <int HD>
__device__ __forceinline__ void tile_p_ds(const float* qsh, const float* dosh,
                                          const float* ksh, const float* vsh,
                                          const float* lse_sh, const float* dl_sh,
                                          float* psh, float* dssh, int q0, int k0,
                                          int sq, int sk, int causal, int window,
                                          float scale) {
  constexpr int LD = Cfg<HD>::LD, LDP = Cfg<HD>::LDP;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;  // rows tr, tr + 16; keys tc, tc + 16
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qa[2], oa[2], kb[2], vb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(qsh + (tr + 16 * i) * LD + d);
      oa[i] = *reinterpret_cast<const float4*>(dosh + (tr + 16 * i) * LD + d);
      kb[i] = *reinterpret_cast<const float4*>(ksh + (tc + 16 * i) * LD + d);
      vb[i] = *reinterpret_cast<const float4*>(vsh + (tc + 16 * i) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = dot4(qa[i], kb[j], s[i][j]);
        dp[i][j] = dot4(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tr + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tc + 16 * j, key = k0 + c;
      bool ok = row < sq && key < sk;
      if (causal) ok = ok && key <= row;
      if (window > 0) ok = ok && row - key < window;
      const float p = ok ? expf(s[i][j] * scale - lse_sh[r]) : 0.f;
      if (psh != nullptr) psh[r * LDP + c] = p;
      dssh[r * LDP + c] = p * (dp[i][j] - dl_sh[r]);
    }
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d]: one warp per row
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int hq, int sq, long long rows,
                       Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / sq;
  const int i = (int)(row - bh * sq), h = (int)(bh % hq), bi = (int)(bh / hq);
  const float* orow = o + bi * os.b + h * os.h + i * os.s;
  const float* drow = dout + bi * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = 4 * lane; d < HD; d += 128)
    acc = dot4(*reinterpret_cast<const float4*>(orow + d),
               *reinterpret_cast<const float4*>(drow + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of keys [k0, k0 + kB) of one (batch, kv head)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                      int sq, int sk, Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, LDP = C::LDP, NC = C::NC;
  extern __shared__ float4 smem4[];
  float* ksh = reinterpret_cast<float*>(smem4);
  float* vsh = ksh + C::kTile;
  float* qsh = vsh + C::kTile;
  float* dosh = qsh + C::kTile;
  float* psh = dosh + C::kTile;
  float* dssh = psh + kB * LDP;
  float* lse_sh = dssh + kB * LDP;
  float* dl_sh = lse_sh + kB;

  const int hk = blockIdx.x % hkv, bi = blockIdx.x / hkv, group = hq / hkv;
  const int k0 = blockIdx.y * kB;
  load_tile<HD>(ksh, k + bi * ks.b + hk * ks.h, ks.s, k0, sk);
  load_tile<HD>(vsh, v + bi * vs.b + hk * vs.h, vs.s, k0, sk);

  // the q rows that can see a key of this block
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(sq, k0 + kB - 1 + window) : sq;
  const int qb0 = q_begin / kB, qb1 = q_end > q_begin ? (q_end + kB - 1) / kB : qb0;

  const int rg = threadIdx.x >> 5, lane = threadIdx.x & 31;  // keys 4 rg + j, columns lane + 32 i
  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < NC; ++i) adk[j][i] = adv[j][i] = 0.f;

  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const float* qg = q + bi * qs.b + h * qs.h;
    const float* dog = dout + bi * dos.b + h * dos.h;
    const float* lse_g = lse + ((long long)bi * hq + h) * sq;
    const float* dl_g = delta + ((long long)bi * hq + h) * sq;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // the previous step is done with q, dO, P and dS
      load_tile<HD>(qsh, qg, qs.s, q0, sq);
      load_tile<HD>(dosh, dog, dos.s, q0, sq);
      if (threadIdx.x < kB) {
        const int row = q0 + threadIdx.x;
        lse_sh[threadIdx.x] = row < sq ? lse_g[row] : 0.f;
        dl_sh[threadIdx.x] = row < sq ? dl_g[row] : 0.f;
      }
      cp_commit_wait();
      __syncthreads();
      tile_p_ds<HD>(qsh, dosh, ksh, vsh, lse_sh, dl_sh, psh, dssh, q0, k0, sq, sk, causal,
                    window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T q over this block's 32 q rows
      for (int r = 0; r < kB; ++r) {
        float p[4], ds[4], o_[NC], q_[NC];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = psh[r * LDP + 4 * rg + j];
          ds[j] = dssh[r * LDP + 4 * rg + j];
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int d = lane + 32 * i;
          o_[i] = d < HD ? dosh[r * LD + d] : 0.f;
          q_[i] = d < HD ? qsh[r * LD + d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            adv[j][i] = fmaf(p[j], o_[i], adv[j][i]);
            adk[j][i] = fmaf(ds[j], q_[i], adk[j][i]);
          }
      }
    }
  }
  cp_commit_wait();  // where no step ran, the K / V copies are still in flight
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + 4 * rg + j;
    if (key >= sk) continue;
    float* dkrow = dk + bi * dks.b + hk * dks.h + key * dks.s;
    float* dvrow = dv + bi * dvs.b + hk * dvs.h + key * dvs.s;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        dkrow[d] = adk[j][i] * scale;
        dvrow[d] = adv[j][i];
      }
    }
  }
}

// dQ of q rows [q0, q0 + kB) of one (batch, q head)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int hkv, int sq, int sk, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs, int causal,
                    int window, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, LDP = C::LDP, NC = C::NC;
  extern __shared__ float4 smem4[];
  float* qsh = reinterpret_cast<float*>(smem4);
  float* dosh = qsh + C::kTile;
  float* ksh = dosh + C::kTile;
  float* vsh = ksh + C::kTile;
  float* dssh = vsh + C::kTile;  // (the P tile's room is unused here)
  float* lse_sh = dssh + 2 * kB * LDP;
  float* dl_sh = lse_sh + kB;

  const int h = blockIdx.x % hq, bi = blockIdx.x / hq, hk = h / (hq / hkv);
  const int q0 = blockIdx.y * kB;
  load_tile<HD>(qsh, q + bi * qs.b + h * qs.h, qs.s, q0, sq);
  load_tile<HD>(dosh, dout + bi * dos.b + h * dos.h, dos.s, q0, sq);
  if (threadIdx.x < kB) {
    const int row = q0 + threadIdx.x;
    const long long at = ((long long)bi * hq + h) * sq + row;
    lse_sh[threadIdx.x] = row < sq ? lse[at] : 0.f;
    dl_sh[threadIdx.x] = row < sq ? delta[at] : 0.f;
  }
  const float* kg = k + bi * ks.b + hk * ks.h;
  const float* vg = v + bi * vs.b + hk * vs.h;

  // the band of keys these rows can see (the forward's)
  const int kv_end = causal ? min(sk, q0 + kB) : sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jb0 = kv_begin / kB, jb1 = kv_end > kv_begin ? (kv_end + kB - 1) / kB : jb0;

  const int rg = threadIdx.x >> 5, lane = threadIdx.x & 31;  // rows 4 rg + j, columns lane + 32 i
  float adq[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < NC; ++i) adq[j][i] = 0.f;

  for (int jb = jb0; jb < jb1; ++jb) {
    const int k0 = jb * kB;
    __syncthreads();  // the previous step is done with K, V and dS
    load_tile<HD>(ksh, kg, ks.s, k0, sk);
    load_tile<HD>(vsh, vg, vs.s, k0, sk);
    cp_commit_wait();
    __syncthreads();
    tile_p_ds<HD>(qsh, dosh, ksh, vsh, lse_sh, dl_sh, nullptr, dssh, q0, k0, sq, sk, causal,
                  window, scale);
    __syncthreads();
    // dQ += dS k over this block's 32 keys
    for (int c = 0; c < kB; ++c) {
      float ds[4], k_[NC];
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[j] = dssh[(4 * rg + j) * LDP + c];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int d = lane + 32 * i;
        k_[i] = d < HD ? ksh[c * LD + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i) adq[j][i] = fmaf(ds[j], k_[i], adq[j][i]);
    }
  }
  cp_commit_wait();  // where no step ran, the q / dO copies are still in flight
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = q0 + 4 * rg + j;
    if (row >= sq) continue;
    float* dqrow = dq + bi * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dqrow[d] = adq[j][i] * scale;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* delta, int batch, int hq,
           int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
           Strides dos, Strides dqs, Strides dks, Strides dvs, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::smem;
  // the opt-in above 48 KB is set once per process and instantiation
  static bool opted = false;
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const long long rows = (long long)batch * hq * sq;
  const int per_block = kThreads / 32;
  flash_bwd_delta_kernel<HD><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
                               stream>>>(o, dout, delta, hq, sq, rows, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<HD><<<dim3(batch * hkv, (sk + kB - 1) / kB), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, hq, hkv, sq, sk, qs, ks, vs, dos, dks, dvs, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<HD><<<dim3(batch * hq, (sq + kB - 1) / kB), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, hq, hkv, sq, sk, qs, ks, vs, dos, dqs, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dO, dq (batch, hq, sq, hd); k, v, dk, dv (batch, hkv, sk, hd); each
// addressed by its (batch, head, sequence) strides in elements with hd
// contiguous, pointers and strides 16-byte aligned; lse (the forward's) and
// the scratch delta (batch, hq, sq) contiguous f32; hd in {16, 32, 64, 80,
// 112, 128, 256}; hq a multiple of hkv.  Launches three kernels on `stream`;
// returns the first CUDA error.
extern "C" int flash_attention_bwd_launch(
    const float* q, const float* k, const float* v, const float* o, const float* lse,
    const float* dout, float* dq, float* dk, float* dv, float* delta, int batch, int hq,
    int hkv, int sq, int sk, int hd, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, int causal, int window, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss}, dos{do_sb, do_sh, do_ss}, dqs{dq_sb, dq_sh, dq_ss},
      dks{dk_sb, dk_sh, dk_ss}, dvs{dv_sb, dv_sh, dv_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(HD)                                                                      \
  case HD:                                                                                 \
    return launch<HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, batch, hq, hkv, sq, sk, qs, \
                      ks, vs, os, dos, dqs, dks, dvs, causal, window, scale, s);
  switch (hd) {
    REPRO_BWD(16)
    REPRO_BWD(32)
    REPRO_BWD(64)
    REPRO_BWD(80)
    REPRO_BWD(112)
    REPRO_BWD(128)
    REPRO_BWD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}
