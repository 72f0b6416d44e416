// Backward flash attention for Hopper (sm_90a): fp32 in and out, computed on
// the tensor cores with split-TF32 operands; and bf16 in and out on bf16
// mma.sync (the "bf16" section below).
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
// head's dK and dV sum over its g q heads), and ragged Sq and Sk.  q and K
// are hd wide, V, o and dO vd wide (MLA: 192 and 128), scale = hd^-0.5.
//
// What bounds it on this card: operations.  Per (q row, key) pair in the band
// the function needs five products: three of 2 * hd FLOPs (S, dK, dQ) and
// two of 2 * vd (dP, dV).  Every
// product here runs on the tensor cores (mma.sync.m16n8k8, TF32 in, f32
// accumulate) at fp32 accuracy: each operand a is split into big = tf32(a)
// (round half away) and small = a - big, and every product is small.big +
// big.small + big.big (CUTLASS's OpMultiplyAddFastF32), so the bound is
// 3 x 2 x (3 hd + 2 vd) FLOPs a band pair at the 495 TFLOP/s TF32 peak.  This design
// does seven products a pair, not five (S and dP twice, below).  mma.sync
// rather than wgmma: TF32 wgmma takes only K-major operands, and dV / dK
// reduce over the q rows, the outer axis of dO and q.
//
// Schedule.  Two launches on the caller's stream: delta = rowsum(dO * o), one
// warp per row, then the main kernel over a work list of items, one item a
// block, in the list's order (the hardware hands out blocks in blockIdx order
// as SMs free up, so the list's order is a greedy longest-first schedule).
// The wrapper builds the list (`backward.work_list`), sorted by tile steps
// times products a step, longest first.  Two roles:
//   - a dK/dV item owns 32 keys of one (batch, kv head).  K and V stay in
//     shared memory; it walks its group's g q heads and, for each, the 32-row
//     q tiles of the band [lo, hi) that the list gives it, streaming q, dO,
//     lse and delta through a two-stage cp.async ring.  Per step: S and dP
//     (32 x 32), P and dS written transposed (key-major), then dV += P^T dO
//     and dK += dS^T q.
//   - a dQ item owns 32 q rows of one (batch, q head).  q, dO, lse and delta
//     stay in shared memory; it walks the band's kv tiles [lo, hi), streaming
//     K and V through the ring.  Per step: S and dP again (the price of no
//     atomics), dS written row-major, then dQ += dS k.
// Determinism: no atomics.  Every output element belongs to exactly one item
// and is summed by one thread in a fixed order (heads, then q tiles, then
// the rows of a tile in mma order), whichever block runs the item and
// whenever; so two runs give the same bits.
//
// Warps.  8 warps.  S and dP: warp w sums 16 q rows (16 ((w >> 1) & 1)) x
// all 32 keys over its half (w & 1) of hd (S, w < 4) or vd (dP, w >= 4); the
// two halves trade the keys each keeps through shared memory (a 64-thread
// named barrier), so each warp ends with a 16 x 16 tile, eight mma chains in
// flight on the way.  The S warp turns its tile into P and hands it to its
// dP twin (another named barrier), which forms dS.  The products into dK, dV,
// dQ: warp w owns the 32 rows of the item x DW columns of the product's
// width (DW = 32 above 128, 16 at 80-128, 8 below), so width / DW warps take
// part; in a dK/dV item the dK warps and the dV warps may differ in number
// (MLA: 6 warps of 32 dK columns, 8 of 16 dV columns).
// A head dim that is not a multiple of 16 (the MTP block's 56) is padded to
// the next one in the tiles, its columns past 56 zero-filled as the copies
// land (cp.async with src-size 0), so they add nothing to S or dP; the
// gradient columns past 56 are neither computed nor stored.  Nothing is
// copied to pad the model's tensors.
// The reduction axis of each product is permuted inside each 8-wide k-step
// (any order of a sum's terms gives the same product): in S and dP, thread
// (g, t) holds hd columns t E1 .. t E1 + E1 - 1 of a DC-wide chunk (float4
// loads); in the other three it holds q rows (or keys) 2t, 2t + 1 of a k-step
// (float2 loads of P / dS), and output column g of n-tile i is hd column
// E2 g + i of the warp's DW, so dO, q and K fragments are E2-wide loads and
// each thread writes 2 E2 contiguous outputs a row.
// Accumulation: S and dP sum big.big and the two cross terms in separate
// chains over hd (more chains in flight), added once; P is one ex2 a score,
// 2^(S scale log2 e - lse log2 e).  dV, dK and dQ sum each step's product
// (one q tile, or one kv tile) in a fresh fragment and add it to the running
// f32 sum: a dK chain at gemma3's global layer spans 4 heads x 1024 rows, and
// one tensor-core chain that long loses accuracy.
// Shared memory at hd 256: six 32 x 260 tiles (two resident, a ring of two
// stages of two), lse / delta for two stages, two 32 x 40 P / dS tiles, a
// 4 KB P hand-off and an 8 KB exchange of hd halves: 222,720 B, one block per
// SM; MLA's (192, 128) takes 148,992 B.  `step_clocks.py` measures where a
// step of the longest item spends its clocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 32;        // keys of a dK/dV item and of a dQ step; q rows of both
constexpr int LDP = kB + 8;   // P / dS row: float2 fragment loads are conflict-free

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

// T: float or bf16, the element type of q, k, v, dO and the gradients
template <typename T>
struct Params {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  T *dq, *dk, *dv;
  const int4* items;  // (role | block << 1, batch * heads + head, lo, hi)
  int hq, hkv, sq, sk, group, causal, window;
  float scale;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
};

// a width padded to the next multiple of 16 (a pair of warps splits it)
__host__ __device__ constexpr int padded(int d) { return (d + 15) / 16 * 16; }
// S and dP: a warp sums half of a padded width P in chunks of the largest of
// 32, 16, 8 that divides P / 2
__host__ __device__ constexpr int chunk(int p) {
  return (p / 2) % 32 == 0 ? 32 : (p / 2) % 16 == 0 ? 16 : 8;
}
// dV, dK, dQ: the output columns of one warp, for a padded width P
__host__ __device__ constexpr int warp_cols(int p) { return p > 128 ? 32 : p >= 80 ? 16 : 8; }

// DK: the head dim of q and K (S's reduction, dK's and dQ's columns); DV:
// that of V, o and dO (dP's reduction, dV's columns) -- MLA's 192 and 128.
// A width that is not a multiple of 16 (the MTP block's 56) is padded to the
// next one in shared memory with its columns past D zero-filled, so they add
// nothing to S or dP; the output columns past D are neither computed nor
// stored.  Tiles of q and K are LDK floats a row, of V and dO LDV.
template <int DK, int DV>
struct Cfg {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "the head dims must be multiples of 8");
  static constexpr int PK = padded(DK), PV = padded(DV);
  static constexpr int LDK = PK + 4, LDV = PV + 4;   // padded tile rows, floats
  // dK / dQ (DK wide) and dV (DV wide): DWK / DWV columns a warp, E2K / E2V
  // n-tiles; NWK / NWV warps take part
  static constexpr int DWK = warp_cols(PK), E2K = DWK / 8, NWK = DK / DWK;
  static constexpr int DWV = warp_cols(PV), E2V = DWV / 8, NWV = DV / DWV;
  static_assert(DK % DWK == 0 && DV % DWV == 0 && NWK <= kWarps && NWV <= kWarps,
                "the output columns must fit the warps");
  static constexpr int kTileK = kB * LDK, kTileV = kB * LDV;
  static constexpr int kPT = kB * LDP;
  static constexpr int smem = (int)sizeof(float) *
      (3 * (kTileK + kTileV) + 4 * kB + 2 * kPT + 4 * 8 * 32 + kWarps * 8 * 32);
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
  // two blocks an SM where their shared memory fits (228 KB, 1 KB reserved each)
  static constexpr int kMinBlocks = 2 * (smem + 1024) <= 233472 ? 2 : 1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros (rows past Sq / Sk)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// a = big + small: big is a rounded to TF32 (half away from zero), small the
// exact rest, whose low 13 bits the tensor cores ignore
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
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

// two warps meet here: barriers 1-4 join an S warp and its dP twin, 5-8 the
// two hd halves of one product's 16 rows; barrier 0 is __syncthreads
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// rows [r0, r0 + kB) of a (rows, D) tensor at `base` with row stride `rs`
// into a (kB, P + 4) tile, P = padded(D); rows at or past `n` and columns at
// or past D are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long rs, int r0,
                                          int n) {
  constexpr int P = padded(D), LD = P + 4;
  for (int idx = threadIdx.x; idx < kB * P / 4; idx += kThreads) {
    const int r = idx / (P / 4), c4 = idx - r * (P / 4);
    const bool row_ok = r0 + r < n;
    cp_async16(tile + r * LD + 4 * c4, base + (row_ok ? r0 + r : 0) * rs + 4 * c4,
               row_ok && (D == P || 4 * c4 < D));
  }
}
// kB row statistics (lse or delta) from rows [r0, r0 + kB) of `src`; zeros past n
__device__ __forceinline__ void load_stats(float* dst, const float* src, int r0, int n) {
  if (threadIdx.x < kB) {
    const bool ok = r0 + (int)threadIdx.x < n;
    cp_async4(dst + threadIdx.x, src + (ok ? r0 + threadIdx.x : 0), ok);
  }
}

// acc = A B^T for 16 rows of `a` against 32 rows of `b` (row stride LD
// both), over the P / 2 columns from each one's first: a half of S = q k^T
// (P = PK) or of dP = dO v^T (P = PV).  acc[j] holds rows g, g + 8 and keys
// 8j + 2t, 8j + 2t + 1.
template <int P>
__device__ __forceinline__ void scores_half(float (&acc)[4][4], const float* a, const float* b,
                                            int g, int t) {
  constexpr int LD = P + 4, DC = chunk(P), E1 = DC / 4, NK1 = DC / 8;
  float cross[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = cross[j][e] = 0.f;
  const float* ar = a + g * LD + t * E1;
  const float* br = b + g * LD + t * E1;
#pragma unroll
  for (int c = 0; c < P / 2 / DC; ++c) {
    float xa[E1], xb[E1];
    load_row(xa, ar + c * DC);
    load_row(xb, ar + 8 * LD + c * DC);
    uint32_t ab[NK1][4], as[NK1][4];
#pragma unroll
    for (int kk = 0; kk < NK1; ++kk) {
      split(xa[2 * kk], ab[kk][0], as[kk][0]);
      split(xb[2 * kk], ab[kk][1], as[kk][1]);
      split(xa[2 * kk + 1], ab[kk][2], as[kk][2]);
      split(xb[2 * kk + 1], ab[kk][3], as[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[E1];
      load_row(y, br + 8 * j * LD + c * DC);
#pragma unroll
      for (int kk = 0; kk < NK1; ++kk) {
        uint32_t bb0, bs0, bb1, bs1;
        split(y[2 * kk], bb0, bs0);
        split(y[2 * kk + 1], bb1, bs1);
        mma(cross[j], as[kk], bb0, bb1);
        mma(cross[j], ab[kk], bs0, bs1);
        mma(acc[j], ab[kk], bb0, bb1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += cross[j][e];
}

// acc = A B for A (32 x 32, row stride LDP: P^T, dS^T or dS) and B (32 rows
// of a tile with row stride LD, from the warp's first column): acc[m][i]
// holds rows 16m + g, 16m + g + 8 and, for n-tile i, columns E2 (2t) + i,
// E2 (2t + 1) + i
template <int LD, int E2>
__device__ __forceinline__ void product32(float (&acc)[2][E2][4], const float* a,
                                          const float* b, int g, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < E2; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kB / 8; ++kk) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 lo = *reinterpret_cast<const float2*>(a + (16 * m + g) * LDP + 8 * kk + 2 * t);
      const float2 hi =
          *reinterpret_cast<const float2*>(a + (16 * m + g + 8) * LDP + 8 * kk + 2 * t);
      split(lo.x, ab[m][0], as[m][0]);
      split(hi.x, ab[m][1], as[m][1]);
      split(lo.y, ab[m][2], as[m][2]);
      split(hi.y, ab[m][3], as[m][3]);
    }
    float y0[E2], y1[E2];
    load_row(y0, b + (8 * kk + 2 * t) * LD + E2 * g);
    load_row(y1, b + (8 * kk + 2 * t + 1) * LD + E2 * g);
#pragma unroll
    for (int i = 0; i < E2; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma3(acc[m][i], ab[m], as[m], y0[i], y1[i]);
  }
}

template <int E2>
__device__ __forceinline__ void add_into(float (&run)[2][E2][4], const float (&step)[2][E2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < E2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[m][i][e] += step[m][i][e];
}

// rows r0 + 16m + g (+ 8) below n of `acc` times `mul`, to `base` (row stride
// rs) at the thread's 2 E2 contiguous columns
template <int E2>
__device__ __forceinline__ void store_rows(float* base, long long rs, int r0, int n,
                                           const float (&acc)[2][E2][4], float mul, int g) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * m + g + 8 * r;
      if (row >= n) continue;
      float out[2 * E2];
#pragma unroll
      for (int i = 0; i < E2; ++i) {
        out[i] = acc[m][i][2 * r] * mul;
        out[E2 + i] = acc[m][i][2 * r + 1] * mul;
      }
      store_row(base + row * rs, out);
    }
}

template <typename P>
__device__ __forceinline__ bool visible(int row, int key, const P& p) {
  bool ok = row < p.sq && key < p.sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window > 0) ok = ok && row - key < p.window;
  return ok;
}

// S / dP for this warp's 16 x 16 tile of the step (q rows q0 + 16 rh, keys
// k0 + 16 hf), then P (S warps) and dS (dP warps).  The warp sums its half
// hf of the head dim (of q and K for S, of dO and V for dP) for all 32 keys,
// hands the half of the keys that its twin (warp ^ 1) keeps through `xch`,
// and adds the twin's half of its own keys.  P goes to the dP twin through
// `xsh` and, when `pt` is not null, to pt[key][row]; dS goes to dst[key][row]
// (`ds_t`) or dst[row][key].
template <int DK, int DV>
__device__ __forceinline__ void step_p_ds(const Params<float>& p, const float* qsh, const float* dosh,
                                          const float* ksh, const float* vsh,
                                          const float* lse_sh, const float* dl_sh, float* pt,
                                          float* dst, bool ds_t, float* xsh, float* xch, int q0,
                                          int k0) {
  using C = Cfg<DK, DV>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, rh = pair >> 1, hf = pair & 1;
  const bool is_s = warp < 4;
  float part[4][4];
  if constexpr (DK == DV)
    scores_half<C::PK>(part, (is_s ? qsh : dosh) + 16 * rh * C::LDK + hf * (C::PK / 2),
                       (is_s ? ksh : vsh) + hf * (C::PK / 2), g, t);
  else if (is_s)
    scores_half<C::PK>(part, qsh + 16 * rh * C::LDK + hf * (C::PK / 2), ksh + hf * (C::PK / 2),
                       g, t);
  else
    scores_half<C::PV>(part, dosh + 16 * rh * C::LDV + hf * (C::PV / 2), vsh + hf * (C::PV / 2),
                       g, t);
  float* give = xch + warp * 8 * 32 + lane;
  const float* take = xch + (warp ^ 1) * 8 * 32 + lane;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) give[(4 * j + e) * 32] = hf ? part[j][e] : part[2 + j][e];
  pair_sync(5 + (warp >> 1));
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = (hf ? part[2 + j][e] : part[j][e]) + take[(4 * j + e) * 32];
  float* x = xsh + pair * 8 * 32 + lane;
  if (is_s) {
    // P = 2^(S scale log2(e) - lse log2(e)): one ex2 a score
    constexpr float kLog2e = 1.4426950408889634f;
    const float sl = p.scale * kLog2e;
    const float nl[2] = {-lse_sh[16 * rh + g] * kLog2e, -lse_sh[16 * rh + g + 8] * kLog2e};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rh + g + 8 * (e >> 1), c = 16 * hf + 8 * j + 2 * t + (e & 1);
        const float pv =
            visible(q0 + r, k0 + c, p) ? exp2f(fmaf(acc[j][e], sl, nl[e >> 1])) : 0.f;
        x[(4 * j + e) * 32] = pv;
        if (pt != nullptr) pt[c * LDP + r] = pv;
      }
  }
  pair_sync(1 + pair);
  if (!is_s) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rh + g + 8 * (e >> 1), c = 16 * hf + 8 * j + 2 * t + (e & 1);
        const float ds = x[(4 * j + e) * 32] * (acc[j][e] - dl_sh[r]);
        dst[ds_t ? c * LDP + r : r * LDP + c] = ds;
      }
  }
}

// shared memory: tiles 0-1 resident (K / V, or q / dO), 2-5 the ring (stage
// s: a q or K tile, then a dO or V tile), then lse / delta for two stages,
// two P / dS tiles, the P hand-off and the hd halves' exchange.  Tiles of q
// and K are kTileK floats, of V and dO kTileV.
template <int DK, int DV>
struct Smem {
  float *res0, *res1, *ring, *stats, *pa, *pb, *xsh, *xch;
  __device__ __forceinline__ explicit Smem(float* s) {
    using C = Cfg<DK, DV>;
    res0 = s;
    res1 = s + C::kTileK;
    ring = res1 + C::kTileV;
    stats = ring + 2 * (C::kTileK + C::kTileV);
    pa = stats + 4 * kB;
    pb = pa + C::kPT;
    xsh = pb + C::kPT;
    xch = xsh + 4 * 8 * 32;
  }
  __device__ __forceinline__ float* stage(int st) const {
    return ring + st * (Cfg<DK, DV>::kTileK + Cfg<DK, DV>::kTileV);
  }
};

// dK and dV of keys [k0, k0 + kB) of one (batch, kv head): q tiles [lo, hi)
// of each of the group's q heads
template <int DK, int DV>
__device__ __forceinline__ void dkdv_item(const Params<float>& p, float* smem, int bh, int kb, int lo,
                                          int hi) {
  using C = Cfg<DK, DV>;
  constexpr int E2K = C::E2K, E2V = C::E2V;
  const Smem<DK, DV> sm(smem);
  const int hk = bh % p.hkv, bi = bh / p.hkv, k0 = kb * kB;
  load_tile<DK>(sm.res0, p.k + bi * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.sk);
  load_tile<DV>(sm.res1, p.v + bi * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.sk);
  const int nq = hi - lo, n = p.group * nq;
  auto issue = [&](int step, int st) {  // q, dO, lse, delta of step `step` into stage st
    const int h = hk * p.group + step / nq, q0 = (lo + step % nq) * kB;
    float* qs = sm.stage(st);
    load_tile<DK>(qs, p.q + bi * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
    load_tile<DV>(qs + C::kTileK, p.dout + bi * p.dos.b + h * p.dos.h, p.dos.s, q0, p.sq);
    const long long rows = ((long long)bi * p.hq + h) * p.sq;
    load_stats(sm.stats + 2 * kB * st, p.lse + rows, q0, p.sq);
    load_stats(sm.stats + 2 * kB * st + kB, p.delta + rows, q0, p.sq);
  };
  if (n > 0) issue(0, 0);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float adk[2][E2K][4], adv[2][E2V][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < E2K; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[m][i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < E2V; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) adv[m][i][e] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();  // step it has landed; every warp is done with step it - 1
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_commit();
    const float* qsh = sm.stage(st);
    const float* dosh = qsh + C::kTileK;
    const float* lse_sh = sm.stats + 2 * kB * st;
    step_p_ds<DK, DV>(p, qsh, dosh, sm.res0, sm.res1, lse_sh, lse_sh + kB, sm.pa, sm.pb, true,
                      sm.xsh, sm.xch, (lo + it % nq) * kB, k0);
    __syncthreads();  // P^T and dS^T are whole
    if constexpr (DK == DV) {  // one step fragment for both products
      if (warp < C::NWK) {
        float step[2][E2K][4];
        product32<C::LDV>(step, sm.pa, dosh + warp * C::DWV, g, t);
        add_into(adv, step);
        product32<C::LDK>(step, sm.pb, qsh + warp * C::DWK, g, t);
        add_into(adk, step);
      }
    } else {
      if (warp < C::NWV) {
        float step[2][E2V][4];
        product32<C::LDV>(step, sm.pa, dosh + warp * C::DWV, g, t);
        add_into(adv, step);
      }
      if (warp < C::NWK) {
        float step[2][E2K][4];
        product32<C::LDK>(step, sm.pb, qsh + warp * C::DWK, g, t);
        add_into(adk, step);
      }
    }
  }
  cp_wait_all();  // where no step ran, the K / V copies are still in flight
  if (warp < C::NWK) {
    const int col = warp * C::DWK + 2 * t * E2K;
    store_rows(p.dk + bi * p.dks.b + hk * p.dks.h + col, p.dks.s, k0, p.sk, adk, p.scale, g);
  }
  if (warp < C::NWV) {
    const int col = warp * C::DWV + 2 * t * E2V;
    store_rows(p.dv + bi * p.dvs.b + hk * p.dvs.h + col, p.dvs.s, k0, p.sk, adv, 1.f, g);
  }
}

// dQ of q rows [q0, q0 + kB) of one (batch, q head): kv tiles [lo, hi)
template <int DK, int DV>
__device__ __forceinline__ void dq_item(const Params<float>& p, float* smem, int bh, int qb, int lo,
                                        int hi) {
  using C = Cfg<DK, DV>;
  constexpr int E2K = C::E2K;
  const Smem<DK, DV> sm(smem);
  const int h = bh % p.hq, bi = bh / p.hq, hk = h / p.group, q0 = qb * kB;
  const long long rows = ((long long)bi * p.hq + h) * p.sq;
  load_tile<DK>(sm.res0, p.q + bi * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
  load_tile<DV>(sm.res1, p.dout + bi * p.dos.b + h * p.dos.h, p.dos.s, q0, p.sq);
  load_stats(sm.stats, p.lse + rows, q0, p.sq);
  load_stats(sm.stats + kB, p.delta + rows, q0, p.sq);
  const int n = hi - lo;
  auto issue = [&](int step, int st) {  // K and V of kv tile lo + step into stage st
    const int k0 = (lo + step) * kB;
    float* ks = sm.stage(st);
    load_tile<DK>(ks, p.k + bi * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.sk);
    load_tile<DV>(ks + C::kTileK, p.v + bi * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.sk);
  };
  if (n > 0) issue(0, 0);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float adq[2][E2K][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < E2K; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) adq[m][i][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();  // step it has landed; every warp is done with step it - 1
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_commit();
    const float* ksh = sm.stage(st);
    step_p_ds<DK, DV>(p, sm.res0, sm.res1, ksh, ksh + C::kTileK, sm.stats, sm.stats + kB,
                      nullptr, sm.pa, false, sm.xsh, sm.xch, q0, (lo + it) * kB);
    __syncthreads();  // dS is whole
    if (warp < C::NWK) {
      float step[2][E2K][4];
      product32<C::LDK>(step, sm.pa, ksh + warp * C::DWK, g, t);
      add_into(adq, step);
    }
  }
  cp_wait_all();  // where no step ran, the q / dO copies are still in flight
  if (warp < C::NWK) {
    const int col = warp * C::DWK + 2 * t * E2K;
    store_rows(p.dq + bi * p.dqs.b + h * p.dqs.h + col, p.dqs.s, q0, p.sq, adq, p.scale, g);
  }
}

// ------------------------------------------------------------------ bf16
//
// The same function at bf16 in and out (`flash_attention_bwd_bf16_launch`),
// what the reference's `_flash_bwd` computes for bf16 inputs: q, k, v, o and
// dO upcast to f32, delta = rowsum(dO * o) in f32, P from the f32 lse, dV
// from bf16(P), dS = P * (dP - delta) in f32, and dQ, dK, dV each rounded to
// bf16 once.  The work list, the two launches, the warps' roles and the
// order of every sum over steps are the fp32 kernel's; no atomics.
//
// Products.  S = q k^T, dP = dO v^T and dV += bf16(P)^T dO have bf16
// operands, so they run exactly on mma.sync.m16n8k16 bf16 with f32
// accumulators (a bf16 product is exact in f32).  dK = dS^T q and dQ = dS k
// take the f32 dS: it is split into hi = bf16(dS) and lo = bf16(dS - hi),
// two bf16 mmas against the exact q or k (|dS - hi - lo| <= 2^-16 |dS|,
// against bf16's 2^-8 output rounding).  The reference scales q by hd^-0.5
// in f32 before q k^T and dS^T q; q * scale is not a bf16 value (but at hd
// 256), so here the scale multiplies S inside the exponent and the f32 dK
// sum once, as in the fp32 kernel: that moves each by one f32 rounding of
// q * scale (2^-24 relative), nothing at bf16.
//
// Tiles are bf16 in shared memory, rows padded by 8 values (16 bytes) so
// that the 8 rows of an ldmatrix phase fall on 8 distinct bank groups; A
// fragments come from ldmatrix, B fragments of q, K and dO (whose reduction
// axis is their row) from ldmatrix.trans.  S and dP: warp w (S for w < 4,
// dP for w >= 4) sums a 16 x 16 tile (q rows 16 ((w >> 1) & 1), keys 16 (w
// & 1)) over the whole head dim; the S warp turns it into P and hands it to
// its dP twin through shared memory (a 64-thread named barrier), which forms
// dS.  P^T (bf16) and dS (hi and lo) are written to shared memory, key-major
// in a dK/dV item.  The products into dK, dV and dQ: warp w owns the 32
// rows of the item and DW columns (32 above 128, else 16), each step's
// product summed in a fresh fragment and added to the running f32 sum, as
// in the fp32 kernel.  Shared memory at hd 256: six 32 x 264 bf16 tiles,
// three 32 x 40 bf16 P / dS tiles, lse / delta for two stages and the 4 KB
// P hand-off: 113,664 B.

using bf16 = __nv_bfloat16;

constexpr int LDPB = kB + 8;  // bf16 P / dS row: 80 bytes, ldmatrix conflict-free

template <int DK, int DV>
struct CfgB {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "the head dims must be multiples of 8");
  static constexpr int PK = padded(DK), PV = padded(DV);
  static constexpr int LDK = PK + 8, LDV = PV + 8;  // padded tile rows, bf16 values
  static constexpr int NK = PK / 16, NV = PV / 16;  // 16-wide k-steps of S and of dP
  // dK / dQ (DK wide) and dV (DV wide): DWK / DWV columns a warp, NWK / NWV
  // warps take part (the last one's columns past the head dim are not stored)
  static constexpr int DWK = PK > 128 ? 32 : 16, DWV = PV > 128 ? 32 : 16;
  static constexpr int NWK = (DK + DWK - 1) / DWK, NWV = (DV + DWV - 1) / DWV;
  static_assert(NWK <= kWarps && NWV <= kWarps, "the output columns must fit the warps");
  static constexpr int kTileK = kB * LDK, kTileV = kB * LDV, kPT = kB * LDPB;
  static constexpr int smem = (int)sizeof(bf16) * (3 * (kTileK + kTileV) + 3 * kPT) +
                              (int)sizeof(float) * (4 * kB + 4 * 8 * 32);
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
  static constexpr int kMinBlocks = 1;
};

__device__ __forceinline__ void cp_async16b(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i holds matrix i's (row g, columns 2t, 2t + 1) -- with
// .trans its (rows 2t, 2t + 1, column g)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b, a 16 x 16 and b 16 x 8 bf16, c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, `lo` in the low half (the smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// rows [r0, r0 + kB) of a (rows, D) bf16 tensor at `base` with row stride
// `rs` into a (kB, P + 8) tile, P = padded(D); rows at or past `n` and
// columns at or past D are zeros
template <int D>
__device__ __forceinline__ void load_tile_b(bf16* tile, const bf16* base, long long rs, int r0,
                                            int n) {
  constexpr int P = padded(D), LD = P + 8;
  for (int idx = threadIdx.x; idx < kB * P / 8; idx += kThreads) {
    const int r = idx / (P / 8), c8 = idx - r * (P / 8);
    const bool row_ok = r0 + r < n;
    cp_async16b(tile + r * LD + 8 * c8, base + (row_ok ? r0 + r : 0) * rs + 8 * c8,
                row_ok && (D == P || 8 * c8 < D));
  }
}

// acc = A B^T for 16 rows of `a` (from row 16 rh) against 16 rows of `b`
// (from row 16 kh), row stride LD both, over NS 16-wide k-steps: S = q k^T
// or dP = dO v^T.  acc[j] holds rows g, g + 8 and keys 8j + 2t, 8j + 2t + 1.
template <int NS, int LD>
__device__ __forceinline__ void scores_b(float (&acc)[2][4], const bf16* a, const bf16* b,
                                         int rh, int kh, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* ar = a + (16 * rh + (lane & 15)) * LD + 8 * (lane >> 4);
  const bf16* br = b + (16 * kh + (lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    uint32_t fa[4], fb[4];
    ldsm4(fa, ar + 16 * c);
    ldsm4(fb, br + 16 * c);
    mma_bf16(acc[0], fa, fb[0], fb[1]);
    mma_bf16(acc[1], fa, fb[2], fb[3]);
  }
}

// acc = A B for A (32 x 32 bf16, row stride LDPB: P^T, or dS^T / dS as hi
// and, with SPLIT, lo) and B (32 rows of a tile with row stride LD, from the
// warp's first column; read transposed): acc[m][i] holds rows 16m + g,
// 16m + g + 8 and columns 8i + 2t, 8i + 2t + 1
template <int LD, int DW, bool SPLIT>
__device__ __forceinline__ void product_b(float (&acc)[2][DW / 8][4], const bf16* ah,
                                          const bf16* al, const bf16* b, int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
  const bf16* bl = b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  const int arow = (lane & 15) * LDPB + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    uint32_t fb[DW / 16][4];
#pragma unroll
    for (int c = 0; c < DW / 16; ++c) ldsm4_t(fb[c], bl + 16 * kk * LD + 16 * c);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t fa[4];
      if constexpr (SPLIT) {  // the small part first
        ldsm4(fa, al + 16 * m * LDPB + arow + 16 * kk);
#pragma unroll
        for (int c = 0; c < DW / 16; ++c) {
          mma_bf16(acc[m][2 * c], fa, fb[c][0], fb[c][1]);
          mma_bf16(acc[m][2 * c + 1], fa, fb[c][2], fb[c][3]);
        }
      }
      ldsm4(fa, ah + 16 * m * LDPB + arow + 16 * kk);
#pragma unroll
      for (int c = 0; c < DW / 16; ++c) {
        mma_bf16(acc[m][2 * c], fa, fb[c][0], fb[c][1]);
        mma_bf16(acc[m][2 * c + 1], fa, fb[c][2], fb[c][3]);
      }
    }
  }
}

// rows r0 + 16m + g (+ 8) below n of `acc` times `mul`, rounded to bf16, to
// `base` (row stride rs) at columns col0 + 8i + 2t, + 1 below D
template <int DW, int D>
__device__ __forceinline__ void store_rows_b(bf16* base, long long rs, int r0, int n,
                                             const float (&acc)[2][DW / 8][4], float mul,
                                             int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * m + g + 8 * r;
      if (row >= n) continue;
#pragma unroll
      for (int i = 0; i < DW / 8; ++i) {
        const int col = col0 + 8 * i;  // D is a multiple of 8: an n-tile is in or out
        if (col >= D) continue;
        *reinterpret_cast<uint32_t*>(base + row * rs + col + 2 * t) =
            pack_bf16(acc[m][i][2 * r] * mul, acc[m][i][2 * r + 1] * mul);
      }
    }
}

// S / dP for this warp's 16 x 16 tile of the step (q rows q0 + 16 rh, keys
// k0 + 16 kh), then P (S warps) and dS (dP warps).  P goes to the dP twin
// through `xsh` and, when `pt` is not null, as bf16 to pt[key][row]; dS goes
// as hi / lo to dsh / dsl at [key][row] (`ds_t`) or [row][key].
template <int DK, int DV>
__device__ __forceinline__ void step_p_ds_b(const Params<bf16>& p, const bf16* qsh, const bf16* dosh,
                                            const bf16* ksh, const bf16* vsh,
                                            const float* lse_sh, const float* dl_sh, bf16* pt,
                                            bf16* dsh, bf16* dsl, bool ds_t, float* xsh,
                                            int q0, int k0) {
  using C = CfgB<DK, DV>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, rh = pair >> 1, kh = pair & 1;
  const bool is_s = warp < 4;
  float acc[2][4];
  if (is_s)
    scores_b<C::NK, C::LDK>(acc, qsh, ksh, rh, kh, lane);
  else
    scores_b<C::NV, C::LDV>(acc, dosh, vsh, rh, kh, lane);
  float* hand = xsh + pair * 8 * 32 + lane;  // the P hand-off
  if (is_s) {
    // P = 2^(S scale log2(e) - lse log2(e)): one ex2 a score
    constexpr float kLog2e = 1.4426950408889634f;
    const float sl = p.scale * kLog2e;
    const float nl[2] = {-lse_sh[16 * rh + g] * kLog2e, -lse_sh[16 * rh + g + 8] * kLog2e};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rh + g + 8 * (e >> 1), c = 16 * kh + 8 * j + 2 * t + (e & 1);
        const float pv =
            visible(q0 + r, k0 + c, p) ? exp2f(fmaf(acc[j][e], sl, nl[e >> 1])) : 0.f;
        hand[(4 * j + e) * 32] = pv;
        if (pt != nullptr) pt[c * LDPB + r] = __float2bfloat16_rn(pv);
      }
  }
  pair_sync(1 + pair);
  if (!is_s) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rh + g + 8 * (e >> 1), c = 16 * kh + 8 * j + 2 * t + (e & 1);
        const float ds = hand[(4 * j + e) * 32] * (acc[j][e] - dl_sh[r]);
        const bf16 hi = __float2bfloat16_rn(ds);
        const int at = ds_t ? c * LDPB + r : r * LDPB + c;
        dsh[at] = hi;
        dsl[at] = __float2bfloat16_rn(ds - __bfloat162float(hi));
      }
  }
}

// shared memory: tiles 0-1 resident (K / V, or q / dO), 2-5 the ring (stage
// s: a q or K tile, then a dO or V tile), the P^T tile and dS's hi and lo
// tiles (bf16), then lse / delta for two stages and the P hand-off (f32)
template <int DK, int DV>
struct SmemB {
  bf16 *res0, *res1, *ring, *pt, *dsh, *dsl;
  float *stats, *xsh;
  __device__ __forceinline__ explicit SmemB(bf16* s) {
    using C = CfgB<DK, DV>;
    res0 = s;
    res1 = s + C::kTileK;
    ring = res1 + C::kTileV;
    pt = ring + 2 * (C::kTileK + C::kTileV);
    dsh = pt + C::kPT;
    dsl = dsh + C::kPT;
    stats = reinterpret_cast<float*>(dsl + C::kPT);
    xsh = stats + 4 * kB;
  }
  __device__ __forceinline__ bf16* stage(int st) const {
    return ring + st * (CfgB<DK, DV>::kTileK + CfgB<DK, DV>::kTileV);
  }
};

template <int DW>
__device__ __forceinline__ void zero_acc(float (&acc)[2][DW / 8][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < DW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
}

// dK and dV of keys [k0, k0 + kB) of one (batch, kv head): q tiles [lo, hi)
// of each of the group's q heads
template <int DK, int DV>
__device__ __forceinline__ void dkdv_item(const Params<bf16>& p, bf16* smem, int bh, int kb,
                                          int lo, int hi) {
  using C = CfgB<DK, DV>;
  constexpr int DWK = C::DWK, DWV = C::DWV;
  const SmemB<DK, DV> sm(smem);
  const int hk = bh % p.hkv, bi = bh / p.hkv, k0 = kb * kB;
  load_tile_b<DK>(sm.res0, p.k + bi * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.sk);
  load_tile_b<DV>(sm.res1, p.v + bi * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.sk);
  const int nq = hi - lo, n = p.group * nq;
  auto issue = [&](int step, int st) {  // q, dO, lse, delta of step `step` into stage st
    const int h = hk * p.group + step / nq, q0 = (lo + step % nq) * kB;
    bf16* qs = sm.stage(st);
    load_tile_b<DK>(qs, p.q + bi * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
    load_tile_b<DV>(qs + C::kTileK, p.dout + bi * p.dos.b + h * p.dos.h, p.dos.s, q0, p.sq);
    const long long rows = ((long long)bi * p.hq + h) * p.sq;
    load_stats(sm.stats + 2 * kB * st, p.lse + rows, q0, p.sq);
    load_stats(sm.stats + 2 * kB * st + kB, p.delta + rows, q0, p.sq);
  };
  if (n > 0) issue(0, 0);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float adk[2][DWK / 8][4], adv[2][DWV / 8][4];
  zero_acc<DWK>(adk);
  zero_acc<DWV>(adv);

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();  // step it has landed; every warp is done with step it - 1
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_commit();
    const bf16* qsh = sm.stage(st);
    const bf16* dosh = qsh + C::kTileK;
    const float* lse_sh = sm.stats + 2 * kB * st;
    step_p_ds_b<DK, DV>(p, qsh, dosh, sm.res0, sm.res1, lse_sh, lse_sh + kB, sm.pt, sm.dsh,
                        sm.dsl, true, sm.xsh, (lo + it % nq) * kB, k0);
    __syncthreads();  // P^T and dS^T are whole
    if (warp < C::NWV) {
      float step[2][DWV / 8][4];
      product_b<C::LDV, DWV, false>(step, sm.pt, nullptr, dosh + warp * DWV, lane);
      add_into(adv, step);
    }
    if (warp < C::NWK) {
      float step[2][DWK / 8][4];
      product_b<C::LDK, DWK, true>(step, sm.dsh, sm.dsl, qsh + warp * DWK, lane);
      add_into(adk, step);
    }
  }
  cp_wait_all();  // where no step ran, the K / V copies are still in flight
  if (warp < C::NWK)
    store_rows_b<DWK, DK>(p.dk + bi * p.dks.b + hk * p.dks.h, p.dks.s, k0, p.sk, adk, p.scale,
                          warp * DWK, lane);
  if (warp < C::NWV)
    store_rows_b<DWV, DV>(p.dv + bi * p.dvs.b + hk * p.dvs.h, p.dvs.s, k0, p.sk, adv, 1.f,
                          warp * DWV, lane);
}

// dQ of q rows [q0, q0 + kB) of one (batch, q head): kv tiles [lo, hi)
template <int DK, int DV>
__device__ __forceinline__ void dq_item(const Params<bf16>& p, bf16* smem, int bh, int qb,
                                        int lo, int hi) {
  using C = CfgB<DK, DV>;
  constexpr int DWK = C::DWK;
  const SmemB<DK, DV> sm(smem);
  const int h = bh % p.hq, bi = bh / p.hq, hk = h / p.group, q0 = qb * kB;
  const long long rows = ((long long)bi * p.hq + h) * p.sq;
  load_tile_b<DK>(sm.res0, p.q + bi * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
  load_tile_b<DV>(sm.res1, p.dout + bi * p.dos.b + h * p.dos.h, p.dos.s, q0, p.sq);
  load_stats(sm.stats, p.lse + rows, q0, p.sq);
  load_stats(sm.stats + kB, p.delta + rows, q0, p.sq);
  const int n = hi - lo;
  auto issue = [&](int step, int st) {  // K and V of kv tile lo + step into stage st
    const int k0 = (lo + step) * kB;
    bf16* ks = sm.stage(st);
    load_tile_b<DK>(ks, p.k + bi * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.sk);
    load_tile_b<DV>(ks + C::kTileK, p.v + bi * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.sk);
  };
  if (n > 0) issue(0, 0);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float adq[2][DWK / 8][4];
  zero_acc<DWK>(adq);

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    __syncthreads();  // step it has landed; every warp is done with step it - 1
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_commit();
    const bf16* ksh = sm.stage(st);
    step_p_ds_b<DK, DV>(p, sm.res0, sm.res1, ksh, ksh + C::kTileK, sm.stats, sm.stats + kB,
                        nullptr, sm.dsh, sm.dsl, false, sm.xsh, q0, (lo + it) * kB);
    __syncthreads();  // dS is whole
    if (warp < C::NWK) {
      float step[2][DWK / 8][4];
      product_b<C::LDK, DWK, true>(step, sm.dsh, sm.dsl, ksh + warp * DWK, lane);
      add_into(adq, step);
    }
  }
  cp_wait_all();  // where no step ran, the q / dO copies are still in flight
  if (warp < C::NWK)
    store_rows_b<DWK, DK>(p.dq + bi * p.dqs.b + h * p.dqs.h, p.dqs.s, q0, p.sq, adq, p.scale,
                          warp * DWK, lane);
}

// ------------------------------------------------------- both element types

// the tile configuration of each element type
template <typename T, int DK, int DV>
struct CfgOf {
  using type = Cfg<DK, DV>;
};
template <int DK, int DV>
struct CfgOf<bf16, DK, DV> {
  using type = CfgB<DK, DV>;
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, CfgOf<T, DK, DV>::type::kMinBlocks)
flash_bwd_kernel(const Params<T> p) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int4 item = p.items[blockIdx.x];
  if (item.x & 1)
    dq_item<DK, DV>(p, smem, item.y, item.x >> 1, item.z, item.w);
  else
    dkdv_item<DK, DV>(p, smem, item.y, item.x >> 1, item.z, item.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// this lane's share of sum_d o[d] * dO[d] over a row's DV columns, in f32:
// float4 loads, or 8 bf16 values a load, each upcast
template <int DV>
__device__ __forceinline__ float row_dot(const float* orow, const float* drow, int lane) {
  float acc = 0.f;
  for (int d = 4 * lane; d < DV; d += 128)
    acc = dot4(*reinterpret_cast<const float4*>(orow + d),
               *reinterpret_cast<const float4*>(drow + d), acc);
  return acc;
}
template <int DV>
__device__ __forceinline__ float row_dot(const bf16* orow, const bf16* drow, int lane) {
  float acc = 0.f;
  for (int d = 8 * lane; d < DV; d += 256) {
    const int4 a = *reinterpret_cast<const int4*>(orow + d);
    const int4 b = *reinterpret_cast<const int4*>(drow + d);
    const uint32_t wa[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z, (uint32_t)a.w};
    const uint32_t wb[4] = {(uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z, (uint32_t)b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the low half of a word is the lower column
      acc = fmaf(__uint_as_float(wa[e] << 16), __uint_as_float(wb[e] << 16), acc);
      acc = fmaf(__uint_as_float(wa[e] & 0xffff0000u), __uint_as_float(wb[e] & 0xffff0000u), acc);
    }
  }
  return acc;
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d] over v's DV
// columns: one warp per row
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int hq, int sq, long long rows,
                       Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / sq;
  const int i = (int)(row - bh * sq), h = (int)(bh % hq), bi = (int)(bh / hq);
  float acc = row_dot<DV>(o + bi * os.b + h * os.h + i * os.s,
                          dout + bi * dos.b + h * dos.h + i * dos.s, lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int DK, int DV>
int launch(const Params<T>& p, const T* o, Strides os, float* delta, int batch, int n_items,
           cudaStream_t stream) {
  constexpr int smem = CfgOf<T, DK, DV>::type::smem;
  // the opt-in above 48 KB is set once per process and instantiation
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const long long rows = (long long)batch * p.hq * p.sq;
  flash_bwd_delta_kernel<T, DV><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                                  stream>>>(o, p.dout, delta, p.hq, p.sq, rows, os, p.dos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kernel<T, DK, DV><<<n_items, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const T* q, const T* k, const T* v, const T* o, const float* lse,
               const T* dout, T* dq, T* dk, T* dv, float* delta, const void* items,
               int n_items, int batch, int hq, int hkv, int sq, int sk, int hd, int vd,
               long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
               long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
               long long o_sh, long long o_ss, long long do_sb, long long do_sh,
               long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
               long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
               long long dv_sh, long long dv_ss, int causal, int window, float scale,
               void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 || n_items < 1)
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.items = static_cast<const int4*>(items);
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.scale = scale;
  p.qs = {q_sb, q_sh, q_ss}; p.ks = {k_sb, k_sh, k_ss}; p.vs = {v_sb, v_sh, v_ss};
  p.dos = {do_sb, do_sh, do_ss}; p.dqs = {dq_sb, dq_sh, dq_ss};
  p.dks = {dk_sb, dk_sh, dk_ss}; p.dvs = {dv_sb, dv_sh, dv_ss};
  const Strides os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_BWD_CASE(DK, DV) \
  if (hd == DK && vd == DV) return launch<T, DK, DV>(p, o, os, delta, batch, n_items, s);
  FLASH_BWD_CASE(16, 16)
  FLASH_BWD_CASE(32, 32)
  FLASH_BWD_CASE(56, 56)
  FLASH_BWD_CASE(64, 64)
  FLASH_BWD_CASE(80, 80)
  FLASH_BWD_CASE(112, 112)
  FLASH_BWD_CASE(128, 128)
  FLASH_BWD_CASE(192, 128)
  FLASH_BWD_CASE(256, 256)
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, dq (batch, hq, sq, hd); o, dO (batch, hq, sq, vd); k, dk (batch, hkv,
// sk, hd); v, dv (batch, hkv, sk, vd); all float, or all bf16 for the bf16
// entry; each addressed by its (batch, head, sequence) strides in elements
// with the head dim contiguous, pointers and strides 16-byte aligned; lse
// (the forward's) and the scratch delta (batch, hq, sq) contiguous f32;
// (hd, vd) one of (16, 16), (32, 32), (56, 56), (64, 64), (80, 80), (112,
// 112), (128, 128), (192, 128), (256, 256); hq a multiple of hkv; `items`
// the wrapper's work list, n_items int4s (`backward.work_list`), which must
// cover every output row.  Launches two kernels on `stream`; returns the
// first CUDA error.
#define FLASH_BWD_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(                                                                          \
      const T* q, const T* k, const T* v, const T* o, const float* lse, const T* dout, T* dq,   \
      T* dk, T* dv, float* delta, const void* items, int n_items, int batch, int hq, int hkv,   \
      int sq, int sk, int hd, int vd, long long q_sb, long long q_sh, long long q_ss,           \
      long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,           \
      long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long do_sb,          \
      long long do_sh, long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,      \
      long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,      \
      long long dv_ss, int causal, int window, float scale, void* stream) {                     \
    return launch_any(q, k, v, o, lse, dout, dq, dk, dv, delta, items, n_items, batch, hq, hkv, \
                      sq, sk, hd, vd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,     \
                      o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, \
                      dk_ss, dv_sb, dv_sh, dv_ss, causal, window, scale, stream);               \
  }
FLASH_BWD_ENTRY(flash_attention_bwd_launch, float)
FLASH_BWD_ENTRY(flash_attention_bwd_bf16_launch, bf16)
#undef FLASH_BWD_ENTRY
