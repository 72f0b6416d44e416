// Forward flash attention for Hopper (sm_90a), fp32 in and out, computed on
// the tensor cores with split-TF32 operands.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::_body (the Pallas TPU
// kernel launched by flash_attention_fwd_pallas):
//     o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]
// over the keys j allowed by the mask (j < Sk; j <= i when causal;
// i - j < window when window > 0), with scale = hd^-0.5 (q's head dim, which
// may differ from v's: MLA's q and k are 192 wide, v and o 128), the online-softmax
// state (m, l, acc) and P in f32, the reference's m_safe / corr rules, a fully
// masked row giving 0, and the final divide by max(l, 1e-30).
//
// What bounds it on this card: operations.  QK^T and P.V are 2 * (hd + vd)
// FLOPs per (q row, key) pair inside the band.  On the fp32 FMA units that is 67 TFLOP/s,
// and an FMA loop fed from shared memory reaches a fraction of it.  Here both
// products run on the tensor cores (mma.sync.m16n8k8, TF32 in, f32
// accumulate) at fp32 accuracy: each operand a is split into big = tf32(a)
// and small = tf32(a - big), and every product is small.big + big.small +
// big.big (CUTLASS's OpMultiplyAddFastF32).  The split keeps about 22 bits of
// each operand, the dropped small.small term is below f32 rounding, so the
// result holds the reference's f32 tolerance; three TF32 products cost a third
// of the 495 TFLOP/s TF32 peak, and the split is done in registers as the
// fragments are loaded.  mma.sync rather than wgmma: its 16-row fragments
// per warp keep the online softmax in the accumulator registers, and P goes
// from the QK^T accumulators into the P.V A-fragments without a shuffle.
//
// Layout.  A block owns one (batch, q head) and 64 q rows and walks the kv
// band in steps of 32 keys:
//   - q (64 x hd) is staged once; K (32 x hd) and V (32 x vd) go through a
//     ring of two stages filled by cp.async, so the next step's tiles load
//     while this one computes.  Rows are padded by 4 floats and every
//     fragment load is a float4 (a float2 where a chunk is 8 columns: hd 16,
//     80, 112).  hd 256 takes 216,064 B of shared memory, (192, 128) 150,528
//     B, so one block runs per SM.
//   - A head dim that is not a multiple of 16 (the MTP block's 56) is padded
//     to the next one in its instantiation's tiles: its columns past 56 are
//     zero-filled in shared memory (cp.async with src-size 0, as the rows
//     past Sq / Sk), so they add nothing to QK^T, and the output columns past
//     56 are not stored.  The model's tensors are read in place; nothing is
//     copied to pad them.
//   - 8 warps work in pairs on 16 q rows (one warp of 16 rows alone cannot
//     hide the latency of its dependent mma chains).  Each warp of a pair sums
//     QK^T over half of hd; the two halves are added through shared memory
//     (in the same order by both, so both hold the same scores), both run the
//     same online softmax, and each computes P.V for its half of the vd output
//     columns (64 accumulator registers a thread at vd 256).
//   - The reduction axis of each product is permuted inside each 8-wide k-step
//     (any order of a sum's terms gives the same product): the QK^T fragment
//     of thread (g, t) holds hd columns 8t..8t+7 of a 32-column chunk, and the
//     P.V A-fragment is the QK^T accumulator as it stands (keys 2t, 2t+1).
//     P.V's output columns are permuted too (n-tile i, column g -> hd 4g + i),
//     so V fragments are float4 loads and each thread writes 8 contiguous
//     outputs per 32 columns.
//   - The band skip is the loop's bounds, and a pair whose 16 x 32 tile is all
//     masked skips its products (which leaves (m, l, acc) exactly unchanged).
//   - Causal q blocks are scheduled heaviest first (the last q block has the
//     longest band), so the short blocks fill the card's tail.
// Numerics.  The split operands alone cost ~1.4e-7 of max |o| against
// float64; the tensor cores' accumulation into one long chain costs more:
// at 768 keys with no mask (each output cancelling ~20x) one chain per
// output reaches 6-9e-6 (`flash_attention/accuracy.py`), and hd 64 at 1,024
// keys (seamless-m4t-medium's encoder and cross attention) 1.2e-5, past the
// 1e-5 gate.  HD 64, 80 and 112, the padded 56 and MLA's (192, 128) therefore
// sum each chunk's QK^T and each kv step's P.V in a fresh fragment and add it
// to the running sum in f32 (`Cfg::kFreshAcc`); the other power-of-two head
// dims keep the single chains they were first built with, so their
// outputs are bitwise those of that first build.  The split is temporary:
// the fresh fragments are the more accurate scheme, and every head dim is
// to take them, with a new card measurement of time and error (ROADMAP).
// GQA is the kv head index h // g: a shared kv head is read by its g q heads
// from L2, never copied per head.  Tensors are addressed by (batch, head,
// sequence) strides with hd contiguous, so the model's (B, S, H, hd) layout
// is read and written in place.
//
// The bf16 instantiation is a kernel of its own, on warpgroup `wgmma`
// (`flash_attention_bf16.cu`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kRowWarps = 4;  // warps along the q rows, 16 rows each
constexpr int kWarps = 2 * kRowWarps;  // a pair of warps per 16 rows splits hd
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kRowWarps;  // q rows per block
constexpr int kBk = 32;              // keys per kv step: four 8-key n-tiles
constexpr int kStages = 2;           // K/V ring depth

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

// the column chunk of a fragment load over a warp's half of a padded width P:
// the largest of 32, 16 and 8 that divides P / 2, so that each warp of a pair
// takes whole chunks (P 80 and 112 take chunks of 8, as P 16 does)
__host__ __device__ constexpr int chunk(int p) {
  return (p / 2) % 32 == 0 ? 32 : (p / 2) % 16 == 0 ? 16 : 8;
}
// a width padded to the next multiple of 16 (a pair of warps splits it)
__host__ __device__ constexpr int padded(int d) { return (d + 15) / 16 * 16; }

// DK: the head dim of q and K (QK^T's reduction); DV: that of V and the
// output (MLA's 192 and 128).  A width that is not a multiple of 16 (the
// MTP block's 56) is padded to the next one in shared memory with its
// columns past D zero-filled, so they add nothing to QK^T, and the output
// columns past DV are not stored
template <int DK, int DV>
struct Cfg {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "the head dims must be multiples of 8");
  static constexpr int kU = 4;  // floats in a 16-byte unit
  static constexpr int PK = padded(DK), PV = padded(DV);
  static constexpr int LDK = PK + kU, LDV = PV + kU;  // smem rows padded by one unit
  // QK^T: chunks of DCK columns, EK floats a thread loads per row and
  // chunk, NTK k-steps a chunk, NHK chunks for each warp of a pair
  static constexpr int DCK = chunk(PK), EK = DCK / 4, NTK = DCK / 8, NHK = PK / DCK / 2;
  // P.V: chunks of DCV columns, NTV n-tiles a chunk, NHV chunks a warp
  static constexpr int DCV = chunk(PV), NTV = DCV / 8, NHV = PV / DCV / 2;
  static_assert(DV % (2 * NTV) == 0, "a thread's output columns are all stored or none");
  // the P.V accumulator n-tiles a thread holds
  static constexpr int kAcc = NHV * NTV;
  static constexpr int kQ = kBq * LDK;               // values of the q tile
  static constexpr int kK = kBk * LDK;               // values of one K tile
  static constexpr int kV = kBk * LDV;               // values of one V tile
  static constexpr int kX = kWarps * 16 * 32;        // floats of the score exchange
  // HD 64, 80 and 112, the padded 56 and MLA's (192, 128) sum each
  // chunk's QK^T and each kv step's P.V in a fresh accumulator and add it to
  // the running one in f32; the other head dims keep their single chains,
  // bit for bit (see Numerics)
  static constexpr bool kFreshAcc =
      DK == 64 || DK == 80 || DK == 112 || DK != DV || DK != PK;
  static constexpr int kTiles = (int)sizeof(float) * (kQ + kStages * (kK + kV));  // bytes
  static_assert(kTiles % 16 == 0, "the score exchange starts on a 16-byte boundary");
  static constexpr int smem = kTiles + (int)sizeof(float) * kX;
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past Sq / Sk)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the two warps of a pair (16 q rows) meet here; barrier 0 is __syncthreads
__device__ __forceinline__ void pair_sync(int row_warp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + row_warp) : "memory");
}

// ------------------------------------------------------ split TF32 products

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// a = big + small, both TF32
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = tf32(a);
  small = tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b at f32 accuracy: the two small cross terms first, then big.big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
  }
}
template <>
__device__ __forceinline__ void load_row<2>(float (&dst)[2], const float* src) {
  const float2 v = *reinterpret_cast<const float2*>(src);
  dst[0] = v.x; dst[1] = v.y;
}
template <>
__device__ __forceinline__ void load_row<1>(float (&dst)[1], const float* src) { dst[0] = *src; }

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}
template <>
__device__ __forceinline__ void store_row<2>(float* dst, const float (&src)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
}

// s += q k^T for rows (g, g + 8), keys 8j + 2t + {0, 1}, over this warp's
// half of the q / K columns (hf)
template <int DK, int DV>
__device__ __forceinline__ void qk_half(float (&s)[4][4], const float* qsh, const float* ksh,
                                        int rw, int hf, int lane) {
  using C = Cfg<DK, DV>;
  constexpr int LDK = C::LDK, DCK = C::DCK, EK = C::EK, NTK = C::NTK, NHK = C::NHK;
  const int g = lane >> 2, t = lane & 3;
  const float* qa = qsh + (16 * rw + g) * LDK + hf * NHK * DCK + t * EK;
  const float* kb = ksh + g * LDK + hf * NHK * DCK + t * EK;
#pragma unroll
  for (int c = 0; c < NHK; ++c) {
    float xa[EK], xb[EK];
    load_row(xa, qa + c * DCK);
    load_row(xb, qa + 8 * LDK + c * DCK);
    uint32_t ab[NTK][4], as[NTK][4];
#pragma unroll
    for (int kk = 0; kk < NTK; ++kk) {
      split(xa[2 * kk], ab[kk][0], as[kk][0]);
      split(xb[2 * kk], ab[kk][1], as[kk][1]);
      split(xa[2 * kk + 1], ab[kk][2], as[kk][2]);
      split(xb[2 * kk + 1], ab[kk][3], as[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[EK];
      load_row(y, kb + 8 * j * LDK + c * DCK);
      if constexpr (C::kFreshAcc) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NTK; ++kk) mma3(part, ab[kk], as[kk], y[2 * kk], y[2 * kk + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[e];
      } else {
#pragma unroll
        for (int kk = 0; kk < NTK; ++kk) mma3(s[j], ab[kk], as[kk], y[2 * kk], y[2 * kk + 1]);
      }
    }
  }
}

// acc += P V over this warp's half of the V columns: the A-fragment of
// k-tile j is s[j] (key 2t -> column t, key 2t + 1 -> column t + 4); V
// n-tile i of chunk c, column g is V column c * DCV + NTV * g + i
template <int DK, int DV>
__device__ __forceinline__ void pv_half(float (&acc)[Cfg<DK, DV>::kAcc][4],
                                        const float (&s)[4][4], const float* vsh, int hf,
                                        int lane) {
  using C = Cfg<DK, DV>;
  constexpr int LDV = C::LDV, DCV = C::DCV, NTV = C::NTV, NHV = C::NHV;
  const int g = lane >> 2, t = lane & 3;
  float step[C::kFreshAcc ? NHV * NTV : 1][4];  // this kv step's P.V (kFreshAcc)
  if constexpr (C::kFreshAcc) {
#pragma unroll
    for (int n = 0; n < NHV * NTV; ++n) step[n][0] = step[n][1] = step[n][2] = step[n][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pb[4], pl[4];
    split(s[j][0], pb[0], pl[0]);
    split(s[j][2], pb[1], pl[1]);
    split(s[j][1], pb[2], pl[2]);
    split(s[j][3], pb[3], pl[3]);
    const float* v0 = vsh + (8 * j + 2 * t) * LDV + hf * NHV * DCV + NTV * g;
#pragma unroll
    for (int c = 0; c < NHV; ++c) {
      float y0[NTV], y1[NTV];
      load_row(y0, v0 + c * DCV);
      load_row(y1, v0 + LDV + c * DCV);
#pragma unroll
      for (int i = 0; i < NTV; ++i) {
        if constexpr (C::kFreshAcc) {
          mma3(step[c * NTV + i], pb, pl, y0[i], y1[i]);
        } else {
          mma3(acc[c * NTV + i], pb, pl, y0[i], y1[i]);
        }
      }
    }
  }
  if constexpr (C::kFreshAcc) {
#pragma unroll
    for (int n = 0; n < NHV * NTV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += step[n][e];
  }
}

// thread (g, t) holds, per chunk c of its half, output columns
// c * DCV + 2t * NTV + [0, 2 NTV) of row g + 8r: stored where they lie below DV
template <int DK, int DV>
__device__ __forceinline__ void store_half(float* orow, const float (&acc)[Cfg<DK, DV>::kAcc][4],
                                           int r, float denom, int hf, int lane) {
  using C = Cfg<DK, DV>;
  constexpr int PV = C::PV, DCV = C::DCV, NTV = C::NTV, NHV = C::NHV;
  const int col = hf * NHV * DCV + 2 * (lane & 3) * NTV;
#pragma unroll
  for (int c = 0; c < NHV; ++c) {
    if (DV != PV && col + c * DCV >= DV) continue;
    float out[2 * NTV];
#pragma unroll
    for (int i = 0; i < NTV; ++i) {
      out[i] = acc[c * NTV + i][2 * r] / denom;
      out[NTV + i] = acc[c * NTV + i][2 * r + 1] / denom;
    }
    store_row(orow + col + c * DCV, out);
  }
}

// ------------------------------------------------------------ the kernel

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int hq, int sq, int sk, int group, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale) {
  using C = Cfg<DK, DV>;
  constexpr int PK = C::PK, PV = C::PV, LDK = C::LDK, LDV = C::LDV, U = C::kU;
  extern __shared__ float4 smem4[];
  float* qsh = reinterpret_cast<float*>(smem4);  // (kBq, LDK)
  float* kvsh = qsh + C::kQ;                 // per stage: K (kBk, LDK), V (kBk, LDV)
  // per warp: 16 scores x 32 lanes
  float* xsh = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + C::kTiles);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % kRowWarps;  // the warp's 16 q rows
  const int hf = warp / kRowWarps;  // its half of the columns
  const int h = blockIdx.x % hq, bi = blockIdx.x / hq, hk = h / group;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qb * kBq;
  const float* qg = q + bi * qs.b + h * qs.h;
  const float* kg = k + bi * ks.b + hk * ks.h;
  const float* vg = v + bi * vs.b + hk * vs.h;

  // band of kv steps this q block can see
  const int kv_end = causal ? min(sk, q0 + kBq) : sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int jb0 = kv_begin / kBk;
  const int n_kv = max(0, (kv_end + kBk - 1) / kBk - jb0);

  // 16-byte units cu (U values) of a padded row past the true width are zero-filled
  for (int idx = tid; idx < kBq * PK / U; idx += kThreads) {
    const int r = idx / (PK / U), cu = idx - r * (PK / U);
    const bool row_ok = q0 + r < sq;
    cp_async16(qsh + r * LDK + U * cu, qg + (row_ok ? q0 + r : 0) * qs.s + U * cu,
               row_ok && (DK == PK || U * cu < DK));
  }
  auto load_kv = [&](int jb, int st) {
    float* ksh = kvsh + st * (C::kK + C::kV);
    float* vsh = ksh + C::kK;
    const int k0 = jb * kBk;
    for (int idx = tid; idx < kBk * PK / U; idx += kThreads) {
      const int r = idx / (PK / U), cu = idx - r * (PK / U);
      const long long row = k0 + r < sk ? k0 + r : 0;
      cp_async16(ksh + r * LDK + U * cu, kg + row * ks.s + U * cu,
                 k0 + r < sk && (DK == PK || U * cu < DK));
    }
    for (int idx = tid; idx < kBk * PV / U; idx += kThreads) {
      const int r = idx / (PV / U), cu = idx - r * (PV / U);
      const long long row = k0 + r < sk ? k0 + r : 0;
      cp_async16(vsh + r * LDV + U * cu, vg + row * vs.s + U * cu,
                 k0 + r < sk && (DV == PV || U * cu < DV));
    }
  };
  if (n_kv > 0) load_kv(jb0, 0);
  cp_commit();

  const int r0 = q0 + 16 * rw;  // the warp's first q row
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[C::kAcc][4];  // this warp's P.V n-tiles; rows g, g + 8
#pragma unroll
  for (int n = 0; n < C::kAcc; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kv) load_kv(jb0 + it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();  // everything but the step just issued has landed
    __syncthreads();

    const int k0 = (jb0 + it) * kBk;
    const bool masked_out = k0 >= sk || (causal && k0 > r0 + 15) ||
                            (window > 0 && r0 - (k0 + kBk - 1) >= window);
    if (!masked_out) {  // the same for both warps of the pair
      const float* ksh = kvsh + st * (C::kK + C::kV);
      const float* vsh = ksh + C::kK;

      // s = q k^T for rows (g, g + 8), keys 8j + 2t + {0, 1}: this warp sums
      // its half, then adds the other half from its pair
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      qk_half<DK, DV>(s, qsh, ksh, rw, hf, lane);
      float* mine = xsh + warp * 512 + lane;
      const float* other = xsh + (warp ^ kRowWarps) * 512 + lane;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = s[j][e];
      pair_sync(rw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += other[(4 * j + e) * 32];  // a + b == b + a

      // mask, then the online-softmax update of rows g (r = 0) and g + 8 (r = 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          bool ok = key < sk;
          if (causal) ok = ok && key <= row;
          if (window > 0) ok = ok && row - key < window;
          s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float m_safe[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        m_safe[r] = isfinite(m_new) ? m_new : 0.f;
        corr[r] = isfinite(m_run[r]) ? expf(m_run[r] - m_safe[r]) : 0.f;
        m_run[r] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m_safe[e >> 1]);  // exp(-inf) = 0 where masked
          ps[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
        l_run[r] = l_run[r] * corr[r] + ps[r];
      }
#pragma unroll
      for (int n = 0; n < C::kAcc; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
      pv_half<DK, DV>(acc, s, vsh, hf, lane);  // l sums the unrounded P
    }
    __syncthreads();  // every warp is done with stage st and the exchange
  }
  cp_wait<0>();

  // the log-sum-exp of each row's scaled scores, (batch, hq, sq) contiguous:
  // log(l) + m, and 0 for a row that sees no key (the reference's lse); both
  // warps of a pair hold the same (m, l), so the first half's t == 0 lanes
  // write it.  Nothing here feeds o.
  if (lse != nullptr && hf == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= sq) continue;
      lse[((long long)bi * hq + h) * sq + row] =
          (l_run[r] > 0.f ? logf(l_run[r]) : 0.f) + (isfinite(m_run[r]) ? m_run[r] : 0.f);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= sq) continue;
    store_half<DK, DV>(o + bi * os.b + h * os.h + row * os.s, acc, r,
                       fmaxf(l_run[r], 1e-30f), hf, lane);
  }
}

template <int DK, int DV>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
           int hq, int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<DK, DV>::smem;
  static OptIn opted;  // per device, never per launch
  if (const int err = opt_in_smem(flash_fwd_kernel<DK, DV>, smem, opted)) return err;
  const dim3 grid(batch * hq, (sq + kBq - 1) / kBq);
  flash_fwd_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, hq, sq, sk, hq / hkv, qs, ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

int launch_any(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
               int hq, int hkv, int sq, int sk, int hd, int vd, long long q_sb, long long q_sh,
               long long q_ss, long long k_sb, long long k_sh, long long k_ss,
               long long v_sb, long long v_sh, long long v_ss, long long o_sb,
               long long o_sh, long long o_ss, int causal, int window, float scale,
               void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(DK, DV)                                                            \
  if (hd == DK && vd == DV)                                                           \
    return launch<DK, DV>(q, k, v, o, lse, batch, hq, hkv, sq, sk, qs, ks, vs, os, \
                             causal, window, scale, s);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(56, 56)
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(112, 112)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
  FLASH_CASE(256, 256)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (batch, hq, sq, hd), k (batch, hkv, sk, hd), v (batch, hkv, sk, vd), o
// (batch, hq, sq, vd), each addressed by its (batch, head, sequence) strides
// in elements with the head dim contiguous; lse, when not null, (batch, hq,
// sq) contiguous f32 (the backward's input); pointers and strides 16-byte
// aligned; (hd, vd) one of (16, 16), (32, 32), (56, 56), (64, 64), (80, 80),
// (112, 112), (128, 128), (192, 128), (256, 256); hq a multiple of hkv.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const float* q, const float* k, const float* v, float* o, float* lse, int batch,
    int hq, int hkv, int sq, int sk, int hd, int vd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  return launch_any(q, k, v, o, lse, batch, hq, hkv, sq, sk, hd, vd, q_sb, q_sh, q_ss, k_sb,
                    k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal, window, scale,
                    stream);
}
