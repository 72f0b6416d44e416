// Backward flash attention for Hopper (sm_90a) at bf16 in and out, on
// warpgroup `wgmma` (`flash_attention_bwd_bf16_launch`).
//
// Replaces src/repro/models/flash_attention.py::_flash_bwd (the custom VJP
// the reference trains through) at bf16 inputs, the function of the fp32
// kernel in `flash_attention_bwd.cu`:
//     P  = exp(scale * q k^T - lse)        (masked; recomputed, never stored)
//     dV = bf16(P)^T dO
//     dS = P * (dO v^T - delta),  delta = rowsum(dO * o)
//     dK = scale * dS^T q,        dQ = scale * dS k
// with what the reference computes for bf16 inputs: q, k, v, o and dO upcast
// to f32, delta in f32, P from the forward's f32 lse, dV from bf16(P), dS in
// f32 entering dK and dQ at f32 accuracy as bf16 hi + lo (hi = bf16(dS), lo
// = bf16(dS - hi), two products against the exact q or k: |dS - hi - lo| <=
// 2^-16 |dS|, against bf16's 2^-8 output rounding), and dQ, dK, dV each
// rounded to bf16 once.  The forward's masks (key j visible to query i when
// j < Sk, j <= i if causal, i - j < window if window > 0), GQA (kv head = q
// head // g; a kv head's dK and dV sum over its g q heads), ragged Sq and
// Sk; q and K hd wide, V, o and dO vd wide (MLA: 192 and 128), scale =
// hd^-0.5, which multiplies S inside the exponent and the f32 dK and dQ
// sums once (the reference scales q in f32 first: one f32 rounding apart).
//
// What bounds it on this card: operations.  Five products a (q row, key)
// pair of the band (three of 2 hd FLOPs: S, dK, dQ; two of 2 vd: dP, dV) at
// the 989 TFLOP/s bf16 tensor-core peak; this design does nine (S and dP
// again in the dQ items, and dK and dQ twice, hi and lo).  Every product
// runs on `wgmma.mma_async` (`hopper.cuh`); the transposed operands the
// backward needs (dV = P^T dO and dK = dS^T q reduce over q rows, dQ = dS K
// over keys) are bf16 `wgmma`'s MN-major B reads of the same tiles, so
// nothing is transposed by a copy.
//
// Schedule.  Two launches on the caller's stream: delta = rowsum(dO * o), one
// warp per row, then the main kernel over the wrapper's work list
// (`backward.work_list` at bf16's 64-row tile): longest first, and, where
// `kernel.head_major` says (K and V outgrow the L2), grouped by (batch, kv
// head) and longest first within a group, so that the items in flight share
// their heads' q, dO, K and V in L2.  A block is two warpgroups (256 threads).
// Two roles:
//   - a dK/dV item owns 64 keys of one (batch, kv head).  K and V stay in
//     shared memory; it walks its group's g q heads and, for each, the
//     64-row q tiles of the band [lo, hi), streaming q, dO, lse and delta
//     through a two-stage cp.async ring.  With keys as the 64-row M side it
//     computes S^T = K q^T and dP^T = V dO^T, forms P^T and dS^T = P^T (dP^T
//     - delta) on the accumulators, and sums dV += bf16(P^T) dO and dK +=
//     dS^T q (lo, then hi) with P^T's and dS^T's A fragments in registers;
//     q and dO are read MN-major from the stage.
//   - a dQ item owns 64 q rows of one (batch, q head).  q, dO, lse and delta
//     stay in shared memory; it walks the band's kv tiles [lo, hi),
//     streaming K and V through the ring: S = q K^T, dP = dO V^T, P, dS, and
//     dQ += dS K (lo, then hi), K read MN-major.
// Up to head dim 128 (`solo`) each warpgroup runs an item of its own,
// consecutive items a block (three warpgroups up to 64, where three fit an
// SM's registers at 168 a thread; two above), in a region of shared memory
// of its own with its own named barrier: they drift apart, so one's
// exponentials run beside another's products, and the dV product is in
// flight while dS is formed.  A step is issue-bound (`bf16_clocks.py`):
// the exponentials and the mask run only where needed, on one ex2 a score.  At 192 (MLA) and 256 one warpgroup's registers do not hold dK
// and dV of 64 keys (256 a thread at 256), so the two share an item
// (`pair`): in a dK/dV item warpgroup 0 computes S^T, P^T and dV, warpgroup
// 1 dP^T, dS^T and dK, P^T handed over in f32 through shared memory in
// fragment order (both accumulators have one layout); in a dQ item
// warpgroup 0 computes S and P, warpgroup 1 dP and dS, which it writes as
// bf16 hi and lo tiles (swizzled, K-major), and each sums its columns of
// dQ from them, warpgroup 0 the first half of hd's 64-column atoms (rounded
// up), warpgroup 1 the rest.  Three named barriers a step order the pair's
// hand-offs (the stage landed; P written; dS written).
// The mask is evaluated only on a step whose tile crosses the band's edge,
// Sq or Sk.
// Determinism: no atomics.  Every output element belongs to exactly one item
// and one warpgroup, and is summed in the `wgmma` accumulators of one thread
// in a fixed order (heads, then q tiles, or kv tiles, in the list's order,
// then the rows of a tile in `wgmma` order), whichever block runs the item
// and whenever; so two runs give the same bits.
// A head dim that is not a multiple of 16 (the MTP block's 56) is
// zero-filled to the next one as the copies land, so it adds nothing to S or
// dP; the gradients' N is the true head dim.  Nothing is copied to pad or
// transpose the model's tensors; they are read in place by their (batch,
// head, sequence) strides, and the gradients written in q's, k's and v's
// layouts.  Shared memory: solo, a region a warpgroup of resident K and V
// (or q and dO), two ring stages and lse / delta: 154,624 B for three at hd
// 64, 201,728 B for two at hd 128; pair at hd 256, one such region plus
// the 16 KB P exchange and the 16 KB dS hi / lo tiles, 231,488 B; one block
// an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;  // two warpgroups: a pair's block, the delta kernel's
constexpr int kB = 64;         // keys of a dK/dV item and of a dQ step; q rows of both

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

struct Params {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  const int4* items;  // (role | block << 1, batch * heads + head, lo, hi)
  int n_items, hq, hkv, sq, sk, group, causal, window;
  float scale;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
};

// DK: the head dim of q and K (S's reduction, dK's and dQ's columns); DV:
// that of V, o and dO (dP's reduction, dV's columns) -- MLA's 192 and 128
template <int DK, int DV>
struct Cfg {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "the head dims must be multiples of 8");
  static constexpr int NK = (DK + 15) / 16, NV = (DV + 15) / 16;  // S's and dP's k-steps
  static constexpr int AK = (DK + 63) / 64, AV = (DV + 63) / 64;  // 64-column atoms a row
  static constexpr int kTK = kB * 128 * AK, kTV = kB * 128 * AV;  // bytes: q / K, dO / V tile
  static constexpr int kStage = kTK + kTV;
  // up to 128 wide, each warpgroup runs an item of its own (`solo`); wider,
  // the two warpgroups share one (`pair`)
  static constexpr bool kSolo = DK <= 128 && DV <= 128;
  // solo: a warpgroup's region (byte offsets from its start): the resident
  // tiles, the ring's two stages, then lse / delta (64 f32 each) a stage
  static constexpr int kRing = kTK + kTV, kSStats = kRing + 2 * kStage;
  static constexpr int kSBars = kSStats + 1024, kRegion = kSBars + 1024;  // + 3 mbarriers
  // pair (byte offsets from the aligned base): the resident tiles, the ring,
  // the P exchange (64 x 64 f32), the dS hi and lo tiles (64 x 64 bf16),
  // then lse / delta for two stages and 3 mbarriers; dQ's columns:
  // warpgroup 0 takes the first half of the atoms, rounded up, warpgroup 1
  // the rest
  static constexpr int kXp = kRing + 2 * kStage, kDsh = kXp + 64 * 64 * 4, kDsl = kDsh + 8192;
  static constexpr int kStats = kDsl + 8192, kPBars = kStats + 1024;
  static constexpr int NQ0 = DK <= 64 ? DK : 64 * ((AK + 1) / 2), NQ1 = DK - NQ0;
  // solo: up to 64 wide three warpgroups a block (their registers, 168 a
  // thread, and regions fit an SM), else two; pair: two
  static constexpr int kItems = !kSolo ? 1 : DK <= 64 && DV <= 64 ? 3 : 2;  // items a block
  static constexpr int kBlock = kSolo ? 128 * kItems : kThreads;  // threads a block
  static constexpr int smem = (kSolo ? kItems * kRegion : kPBars + 64) + 1024;  // + alignment
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
};

// kB row statistics (lse or delta) from rows [r0, r0 + kB) of `src` by
// threads 0..kB-1 of the team; zeros past n
__device__ __forceinline__ void load_stats(uint32_t dst, const float* src, int r0, int n,
                                           int tid) {
  if (tid < kB) {
    const bool ok = r0 + tid < n;
    cp_async4(dst + 4 * tid, ok ? src + r0 + tid : src, ok);
  }
}

__device__ __forceinline__ bool visible(int row, int key, const Params& p) {
  bool ok = row < p.sq && key < p.sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window > 0) ok = ok && row - key < p.window;
  return ok;
}
// every pair of q rows [q0, q0 + kB) and keys [k0, k0 + kB) visible: the
// mask need not be evaluated
__device__ __forceinline__ bool inside(int q0, int k0, const Params& p) {
  return q0 + kB <= p.sq && k0 + kB <= p.sk && (!p.causal || k0 + kB - 1 <= q0) &&
         (p.window <= 0 || q0 + kB - 1 - k0 < p.window);
}

// the tensor maps of q, K, V and dO (the kernel's parameters), boxes of 64 rows
struct Maps {
  const CUtensorMap *q, *k, *v, *dout;
};

// the team's mbarriers at `bars`: the resident tiles, then ring stages 0 and 1
__device__ __forceinline__ void init_bars(uint32_t bars, int tid, int barid, int threads) {
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init(bars + 16, 1);
    mbar_init_fence();
  }
  bar(barid, threads);
}

// P^T in place of S^T (a dK/dV tile: element e is key k0 + mrow + 8 ((e /
// 2) % 2), q row q0 + c, c = 8 (e / 4) + ncol + e % 2):
// 2^(S^T scale log2(e) - lse[c] log2(e)), 0 where masked; the mask is
// evaluated only on a tile that crosses the band's edge, Sq or Sk
__device__ __forceinline__ void p_transposed(float (&s)[32], const float* lse, float sl, int q0,
                                             int k0, int mrow, int ncol, const Params& p) {
  if (inside(q0, k0, p)) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = ex2(fmaf(s[e], sl, -lse[8 * (e >> 2) + ncol + (e & 1)] * kLog2e));
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + mrow + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + ncol + (e & 1);
      s[e] = visible(q0 + c, key, p) ? ex2(fmaf(s[e], sl, -lse[c] * kLog2e)) : 0.f;
    }
  }
}
// P in place of S (a dQ tile: element e is q row q0 + r, r = mrow + 8 ((e
// / 2) % 2), key k0 + 8 (e / 4) + ncol + e % 2), lse[r] as above
__device__ __forceinline__ void p_rows(float (&s)[32], const float* lse, float sl, int q0, int k0,
                                       int mrow, int ncol, const Params& p) {
  const float nl[2] = {-lse[mrow] * kLog2e, -lse[mrow + 8] * kLog2e};
  if (inside(q0, k0, p)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = ex2(fmaf(s[e], sl, nl[(e >> 1) & 1]));
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = mrow + 8 * ((e >> 1) & 1), key = k0 + 8 * (e >> 2) + ncol + (e & 1);
      s[e] = visible(q0 + r, key, p) ? ex2(fmaf(s[e], sl, nl[(e >> 1) & 1])) : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) d[e] = 0.f;
}

// rows r0 + 16 w + l / 4 (+ 8) below n of a 64 x N accumulator times `mul`,
// rounded to bf16, to `base` (row stride rs) from column col0
template <int N>
__device__ __forceinline__ void store_acc(bf16* base, long long rs, int r0, int n, int col0,
                                          const float (&acc)[N / 2], float mul) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8 * r;
    if (row >= n) continue;
    bf16* out = base + row * rs + col0 + 2 * (t & 3);
#pragma unroll
    for (int c = 0; c < N / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
  }
}

// c = A B^T for the 64 rows of tile `a` against the 64 rows of tile `b`, both
// K-major over NS k-steps (S = q K^T, dP = dO V^T, or their transposes),
// issued into the open group
template <int NS>
__device__ __forceinline__ void scores(float (&c)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) Mma<64>::ss<0>(c, desc_k<kB>(a, 0, kk), desc_k<kB>(b, 0, kk), 1);
}
template <int NS>
__device__ __forceinline__ void scores_now(float (&c)[32], uint32_t a, uint32_t b) {
  zero(c);
  wg_fence();
  scores<NS>(c, a, b);
  wg_commit();
  wg_wait<0>();
  fence_regs(c);
}

// the A fragments of x = hi + lo (hi = bf16(x), lo = bf16(x - hi)) for the
// four 16-wide k-steps of a 64 x 64 accumulator
__device__ __forceinline__ void split_frags(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                            const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = x[8 * kk + 2 * j], x1 = x[8 * kk + 2 * j + 1];
      ah[kk][j] = pack_bf16(x0, x1);
      al[kk][j] = pack_bf16(x0 - low_f32(ah[kk][j]), x1 - high_f32(ah[kk][j]));
    }
}

// ------------------------------------------------ solo: a warpgroup an item

// dK and dV of keys [k0, k0 + kB) of one (batch, kv head) by one warpgroup:
// q tiles [lo, hi) of each of the group's q heads.  `base` is the
// warpgroup's region.
template <int DK, int DV>
__device__ __forceinline__ void dkdv_solo(const Params& p, const Maps& m, uint32_t base,
                                          const float* stats_f, int bh, int kb, int lo, int hi) {
  using C = Cfg<DK, DV>;
  const int tid = threadIdx.x & 127, barid = 1 + (threadIdx.x >> 7);
  const int hk = bh % p.hkv, bi = bh / p.hkv, k0 = kb * kB;
  const uint32_t ksh = base, vsh = base + C::kTK, bars = base + C::kSBars;
  const int nq = hi - lo, n = p.group * nq;
  auto issue = [&](int step, int st) {  // q, dO, lse, delta of step `step` into stage st
    const int h = hk * p.group + step / nq, q0 = (lo + step % nq) * kB;
    const uint32_t qs = base + C::kRing + st * C::kStage, full = bars + 8 + 8 * st;
    if (tid == 0) {
      mbar_expect(full, C::kStage);
      tma_tile<kB, C::AK>(qs, m.q, full, q0, h, bi);
      tma_tile<kB, C::AV>(qs + C::kTK, m.dout, full, q0, h, bi);
    }
    const long long rows = ((long long)bi * p.hq + h) * p.sq;
    const uint32_t stats = base + C::kSStats + st * 512;
    load_stats(stats, p.lse + rows, q0, p.sq, tid);
    load_stats(stats + 256, p.delta + rows, q0, p.sq, tid);
  };
  if (n > 0) {  // else no q row sees these keys: dK and dV are zeros
    init_bars(bars, tid, barid, 128);
    if (tid == 0) {
      mbar_expect(bars, C::kStage);
      tma_tile<kB, C::AK>(ksh, m.k, bars, k0, hk, bi);
      tma_tile<kB, C::AV>(vsh, m.v, bars, k0, hk, bi);
    }
    issue(0, 0);
  }
  cp_commit();

  // element e of this thread's 64 x 64 tile: key k0 + mrow + 8 ((e / 2) % 2),
  // q row q0 + 8 (e / 4) + ncol + e % 2
  const int mrow = 16 * (tid >> 5) + ((tid & 31) >> 2), ncol = 2 * (tid & 3);
  const float sl = p.scale * kLog2e;
  float adv[DV / 2], adk[DK / 2];
  zero(adv);
  zero(adk);
  if (n > 0) mbar_wait(bars, 0);  // K and V
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    bar(barid, 128);  // step it's statistics have landed; stage st ^ 1 is free
    if (it + 1 < n) issue(it + 1, st ^ 1);
    cp_commit();
    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's q and dO
    const uint32_t qs = base + C::kRing + st * C::kStage;
    const float* lse = stats_f + st * 128;
    const float* delta = lse + 64;
    const int q0 = (lo + it % nq) * kB;
    // S^T = K q^T and dP^T = V dO^T, one group
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    scores<C::NK>(s, ksh, qs);
    scores<C::NV>(dp, vsh, qs + C::kTK);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T = 2^(S^T scale log2(e) - lse log2(e)): one ex2 a score
    p_transposed(s, lse, sl, q0, k0, mrow, ncol, p);
    // dV += bf16(P^T) dO, in flight while dS^T is formed
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
    fence_regs(adv);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<DV>::template rs<1>(adv, pa[kk], desc_mn<kB>(qs + C::kTK, kk, 0), 1);
    wg_commit();
    // dS^T = P^T (dP^T - delta) in f32; dK += dS^T q, the small part first
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - delta[8 * (e >> 2) + ncol + (e & 1)]);
    uint32_t ah[4][4], al[4][4];
    split_frags(ah, al, dp);
    fence_regs(adk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<DK>::template rs<1>(adk, al[kk], desc_mn<kB>(qs, kk, 0), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<DK>::template rs<1>(adk, ah[kk], desc_mn<kB>(qs, kk, 0), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(ah);
    fence_regs(al);
  }
  store_acc<DV>(p.dv + bi * p.dvs.b + hk * p.dvs.h, p.dvs.s, k0, p.sk, 0, adv, 1.f);
  store_acc<DK>(p.dk + bi * p.dks.b + hk * p.dks.h, p.dks.s, k0, p.sk, 0, adk, p.scale);
}

// dQ of q rows [q0, q0 + kB) of one (batch, q head) by one warpgroup: kv
// tiles [lo, hi)
template <int DK, int DV>
__device__ __forceinline__ void dq_solo(const Params& p, const Maps& m, uint32_t base,
                                        const float* stats_f, int bh, int qb, int lo, int hi) {
  using C = Cfg<DK, DV>;
  const int tid = threadIdx.x & 127, barid = 1 + (threadIdx.x >> 7);
  const int h = bh % p.hq, bi = bh / p.hq, hk = h / p.group, q0 = qb * kB;
  const long long rows = ((long long)bi * p.hq + h) * p.sq;
  const uint32_t qsh = base, dosh = base + C::kTK, stats = base + C::kSStats;
  const uint32_t bars = base + C::kSBars;
  const int n = hi - lo;
  auto issue = [&](int step, int st) {  // K and V of kv tile lo + step into stage st
    const uint32_t ks = base + C::kRing + st * C::kStage, full = bars + 8 + 8 * st;
    if (tid == 0) {
      mbar_expect(full, C::kStage);
      tma_tile<kB, C::AK>(ks, m.k, full, (lo + step) * kB, hk, bi);
      tma_tile<kB, C::AV>(ks + C::kTK, m.v, full, (lo + step) * kB, hk, bi);
    }
  };
  if (n > 0) {  // else this q block sees no key: dQ is zeros
    init_bars(bars, tid, barid, 128);
    if (tid == 0) {
      mbar_expect(bars, C::kStage);
      tma_tile<kB, C::AK>(qsh, m.q, bars, q0, h, bi);
      tma_tile<kB, C::AV>(dosh, m.dout, bars, q0, h, bi);
    }
    load_stats(stats, p.lse + rows, q0, p.sq, tid);
    load_stats(stats + 256, p.delta + rows, q0, p.sq, tid);
    issue(0, 0);
  }
  cp_commit();

  // element e of this thread's 64 x 64 tile: q row q0 + mrow + 8 ((e / 2) %
  // 2), key k0 + 8 (e / 4) + ncol + e % 2
  const int mrow = 16 * (tid >> 5) + ((tid & 31) >> 2), ncol = 2 * (tid & 3);
  const float sl = p.scale * kLog2e;
  float adq[DK / 2];
  zero(adq);
  if (n > 0) mbar_wait(bars, 0);  // q and dO
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    cp_wait_all();
    bar(barid, 128);  // the statistics have landed; stage st ^ 1 is free
    if (it + 1 < n) issue(it + 1, st ^ 1);
    mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's K and V
    const uint32_t ks = base + C::kRing + st * C::kStage;
    const int k0 = (lo + it) * kB;
    // S = q K^T and dP = dO V^T, one group
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    scores<C::NK>(s, qsh, ks);
    scores<C::NV>(dp, dosh, ks + C::kTK);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float dl[2] = {stats_f[64 + mrow], stats_f[64 + mrow + 8]};
    p_rows(s, stats_f, sl, q0, k0, mrow, ncol, p);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);  // dS in f32
    // dQ += dS K, the small part first
    uint32_t ah[4][4], al[4][4];
    split_frags(ah, al, dp);
    fence_regs(adq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<DK>::template rs<1>(adq, al[kk], desc_mn<kB>(ks, kk, 0), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<DK>::template rs<1>(adq, ah[kk], desc_mn<kB>(ks, kk, 0), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(adq);
    fence_regs(ah);
    fence_regs(al);
  }
  store_acc<DK>(p.dq + bi * p.dqs.b + h * p.dqs.h, p.dqs.s, q0, p.sq, 0, adq, p.scale);
}

// ------------------------------------------ pair: two warpgroups an item

// dK and dV of keys [k0, k0 + kB) of one (batch, kv head): q tiles [lo, hi)
// of each of the group's q heads
template <int DK, int DV>
__device__ __forceinline__ void dkdv_pair(const Params& p, const Maps& m, uint32_t base,
                                          float* xp, int bh, int kb, int lo, int hi) {
  using C = Cfg<DK, DV>;
  const int tid = threadIdx.x;
  const int hk = bh % p.hkv, bi = bh / p.hkv, k0 = kb * kB;
  const uint32_t ksh = base, vsh = base + C::kTK, bars = base + C::kPBars;
  const int nq = hi - lo, n = p.group * nq;
  auto issue = [&](int step, int st) {  // q, dO, lse, delta of step `step` into stage st
    const int h = hk * p.group + step / nq, q0 = (lo + step % nq) * kB;
    const uint32_t qs = base + C::kRing + st * C::kStage, full = bars + 8 + 8 * st;
    if (tid == 0) {
      mbar_expect(full, C::kStage);
      tma_tile<kB, C::AK>(qs, m.q, full, q0, h, bi);
      tma_tile<kB, C::AV>(qs + C::kTK, m.dout, full, q0, h, bi);
    }
    const long long rows = ((long long)bi * p.hq + h) * p.sq;
    const uint32_t stats = base + C::kStats + st * 512;
    load_stats(stats, p.lse + rows, q0, p.sq, tid);
    load_stats(stats + 256, p.delta + rows, q0, p.sq, tid);
  };
  if (n > 0) {  // else no q row sees these keys: dK and dV are zeros
    init_bars(bars, tid, 1, kThreads);
    if (tid == 0) {
      mbar_expect(bars, C::kStage);
      tma_tile<kB, C::AK>(ksh, m.k, bars, k0, hk, bi);
      tma_tile<kB, C::AV>(vsh, m.v, bars, k0, hk, bi);
    }
    issue(0, 0);
  }
  cp_commit();

  // element e of this thread's 64 x 64 tile: key k0 + mrow + 8 ((e / 2) % 2),
  // q row q0 + 8 (e / 4) + ncol + e % 2
  const int t = tid & 127, mrow = 16 * (t >> 5) + ((t & 31) >> 2), ncol = 2 * (t & 3);
  const float* stats_f = xp + (C::kStats - C::kXp) / 4;
  if (n > 0) mbar_wait(bars, 0);  // K and V
  if (tid < 128) {  // warpgroup 0: S^T, P^T, dV
    const float sl = p.scale * kLog2e;
    float adv[DV / 2];
    zero(adv);
    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      cp_wait_all();
      bar(1, kThreads);  // step it's statistics have landed; stage st ^ 1 is free
      if (it + 1 < n) issue(it + 1, st ^ 1);
      cp_commit();
      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's q and dO
      const uint32_t qs = base + C::kRing + st * C::kStage;
      const float* lse = stats_f + st * 128;
      const int q0 = (lo + it % nq) * kB;
      float s[32];
      scores_now<C::NK>(s, ksh, qs);
      // P^T = 2^(S^T scale log2(e) - lse log2(e)): one ex2 a score
      p_transposed(s, lse, sl, q0, k0, mrow, ncol, p);
#pragma unroll
      for (int e = 0; e < 32; ++e) xp[e * 128 + t] = s[e];
      bar(2, kThreads);  // P^T is written
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
      fence_regs(adv);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<DV>::template rs<1>(adv, pa[kk], desc_mn<kB>(qs + C::kTK, kk, 0), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(adv);
      fence_regs(pa);
    }
    store_acc<DV>(p.dv + bi * p.dvs.b + hk * p.dvs.h, p.dvs.s, k0, p.sk, 0, adv, 1.f);
  } else {  // warpgroup 1: dP^T, dS^T, dK
    float adk[DK / 2];
    zero(adk);
    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      cp_wait_all();
      bar(1, kThreads);
      if (it + 1 < n) issue(it + 1, st ^ 1);
      cp_commit();
      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);
      const uint32_t qs = base + C::kRing + st * C::kStage;
      const float* delta = stats_f + st * 128 + 64;
      float dp[32];
      scores_now<C::NV>(dp, vsh, qs + C::kTK);
      bar(2, kThreads);  // P^T is written
#pragma unroll
      for (int e = 0; e < 32; ++e) {  // dS^T in f32
        const int c = 8 * (e >> 2) + ncol + (e & 1);
        dp[e] = xp[e * 128 + t] * (dp[e] - delta[c]);
      }
      uint32_t ah[4][4], al[4][4];
      split_frags(ah, al, dp);
      fence_regs(adk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // the small part first
        Mma<DK>::template rs<1>(adk, al[kk], desc_mn<kB>(qs, kk, 0), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<DK>::template rs<1>(adk, ah[kk], desc_mn<kB>(qs, kk, 0), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(adk);
      fence_regs(ah);
      fence_regs(al);
    }
    store_acc<DK>(p.dk + bi * p.dks.b + hk * p.dks.h, p.dks.s, k0, p.sk, 0, adk, p.scale);
  }
}

// dQ of q rows [q0, q0 + kB) of one (batch, q head): kv tiles [lo, hi)
template <int DK, int DV>
__device__ __forceinline__ void dq_pair(const Params& p, const Maps& m, uint32_t base, float* xp,
                                        int bh, int qb, int lo, int hi) {
  using C = Cfg<DK, DV>;
  const int tid = threadIdx.x;
  const int h = bh % p.hq, bi = bh / p.hq, hk = h / p.group, q0 = qb * kB;
  const long long rows = ((long long)bi * p.hq + h) * p.sq;
  const uint32_t qsh = base, dosh = base + C::kTK, stats = base + C::kStats;
  const uint32_t bars = base + C::kPBars;
  const int n = hi - lo;
  auto issue = [&](int step, int st) {  // K and V of kv tile lo + step into stage st
    const uint32_t ks = base + C::kRing + st * C::kStage, full = bars + 8 + 8 * st;
    if (tid == 0) {
      mbar_expect(full, C::kStage);
      tma_tile<kB, C::AK>(ks, m.k, full, (lo + step) * kB, hk, bi);
      tma_tile<kB, C::AV>(ks + C::kTK, m.v, full, (lo + step) * kB, hk, bi);
    }
  };
  if (n > 0) {  // else this q block sees no key: dQ is zeros
    init_bars(bars, tid, 1, kThreads);
    if (tid == 0) {
      mbar_expect(bars, C::kStage);
      tma_tile<kB, C::AK>(qsh, m.q, bars, q0, h, bi);
      tma_tile<kB, C::AV>(dosh, m.dout, bars, q0, h, bi);
    }
    load_stats(stats, p.lse + rows, q0, p.sq, tid);
    load_stats(stats + 256, p.delta + rows, q0, p.sq, tid);
    issue(0, 0);
  }
  cp_commit();

  // element e of this thread's 64 x 64 tile: q row q0 + mrow + 8 ((e / 2) %
  // 2), key k0 + 8 (e / 4) + ncol + e % 2
  const int t = tid & 127, mrow = 16 * (t >> 5) + ((t & 31) >> 2), ncol = 2 * (t & 3);
  const float* stats_f = xp + (C::kStats - C::kXp) / 4;
  const uint32_t dsh = base + C::kDsh, dsl = base + C::kDsl;
  if (n > 0) mbar_wait(bars, 0);  // q and dO
  if (tid < 128) {  // warpgroup 0: S, P, dQ's first columns
    float adq[C::NQ0 / 2];
    zero(adq);
    const float sl = p.scale * kLog2e;
    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      cp_wait_all();
      bar(1, kThreads);  // the statistics have landed; stage st ^ 1 is free
      if (it + 1 < n) issue(it + 1, st ^ 1);
      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);  // step it's K and V
      const uint32_t ks = base + C::kRing + st * C::kStage;
      const int k0 = (lo + it) * kB;
      float s[32];
      scores_now<C::NK>(s, qsh, ks);
      p_rows(s, stats_f, sl, q0, k0, mrow, ncol, p);
#pragma unroll
      for (int e = 0; e < 32; ++e) xp[e * 128 + t] = s[e];
      bar(2, kThreads);  // P is written
      bar(3, kThreads);  // dS is written
      fence_regs(adq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // the small part first
        Mma<C::NQ0>::template ss<1>(adq, desc_k<kB>(dsl, 0, kk), desc_mn<kB>(ks, kk, 0), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<C::NQ0>::template ss<1>(adq, desc_k<kB>(dsh, 0, kk), desc_mn<kB>(ks, kk, 0), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(adq);
    }
    store_acc<C::NQ0>(p.dq + bi * p.dqs.b + h * p.dqs.h, p.dqs.s, q0, p.sq, 0, adq, p.scale);
  } else {  // warpgroup 1: dP, dS, dQ's other columns
    float adq[C::NQ1 > 0 ? C::NQ1 / 2 : 1];
    zero(adq);
    for (int it = 0; it < n; ++it) {
      const int st = it & 1;
      cp_wait_all();
      bar(1, kThreads);
      if (it + 1 < n) issue(it + 1, st ^ 1);
      mbar_wait(bars + 8 + 8 * st, (it >> 1) & 1);
      const uint32_t ks = base + C::kRing + st * C::kStage;
      float dp[32];
      scores_now<C::NV>(dp, dosh, ks + C::kTK);
      const float dl[2] = {stats_f[64 + mrow], stats_f[64 + mrow + 8]};
      bar(2, kThreads);  // P is written
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int r = mrow + 8 * ((e >> 1) & 1), c = 8 * (e >> 2) + ncol;
        const float d0 = xp[e * 128 + t] * (dp[e] - dl[(e >> 1) & 1]);
        const float d1 = xp[(e + 1) * 128 + t] * (dp[e + 1] - dl[(e >> 1) & 1]);
        const uint32_t ds_hi = pack_bf16(d0, d1), at = swz<kB>(r, c);
        st_shared32(dsh + at, ds_hi);
        st_shared32(dsl + at, pack_bf16(d0 - low_f32(ds_hi), d1 - high_f32(ds_hi)));
      }
      fence_async();
      bar(3, kThreads);  // dS is written
      if constexpr (C::NQ1 > 0) {
        fence_regs(adq);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<C::NQ1>::template ss<1>(adq, desc_k<kB>(dsl, 0, kk),
                                      desc_mn<kB>(ks, kk, C::NQ0 / 64), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<C::NQ1>::template ss<1>(adq, desc_k<kB>(dsh, 0, kk),
                                      desc_mn<kB>(ks, kk, C::NQ0 / 64), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(adq);
      }
    }
    if constexpr (C::NQ1 > 0)
      store_acc<C::NQ1>(p.dq + bi * p.dqs.b + h * p.dqs.h, p.dqs.s, q0, p.sq, C::NQ0, adq,
                        p.scale);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(Cfg<DK, DV>::kBlock, 1)
flash_bwd_bf16_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo) {
  using C = Cfg<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const Maps m{&tq, &tk, &tv, &tdo};
  if constexpr (C::kSolo) {  // warpgroup w runs item kItems blockIdx.x + w in its own region
    const int wg = threadIdx.x >> 7, idx = C::kItems * blockIdx.x + wg;
    if (idx >= p.n_items) return;
    const uint32_t region = base + wg * C::kRegion;
    const float* stats_f =
        reinterpret_cast<const float*>(smem_raw + (region - raw) + C::kSStats);
    const int4 item = p.items[idx];
    if (item.x & 1)
      dq_solo<DK, DV>(p, m, region, stats_f, item.y, item.x >> 1, item.z, item.w);
    else
      dkdv_solo<DK, DV>(p, m, region, stats_f, item.y, item.x >> 1, item.z, item.w);
  } else {
    float* xp = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kXp);
    const int4 item = p.items[blockIdx.x];
    if (item.x & 1)
      dq_pair<DK, DV>(p, m, base, xp, item.y, item.x >> 1, item.z, item.w);
    else
      dkdv_pair<DK, DV>(p, m, base, xp, item.y, item.x >> 1, item.z, item.w);
  }
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d] over v's DV
// columns in f32, 8 bf16 values a load, each upcast: one warp per row
template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                            float* __restrict__ delta, int hq, int sq, long long rows,
                            Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / sq;
  const int i = (int)(row - bh * sq), h = (int)(bh % hq), bi = (int)(bh / hq);
  const bf16* orow = o + bi * os.b + h * os.h + i * os.s;
  const bf16* drow = dout + bi * dos.b + h * dos.h + i * dos.s;
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int DK, int DV>
int launch(const Params& p, const bf16* o, Strides os, float* delta, int batch, int n_items,
           cudaStream_t stream) {
  constexpr int smem = Cfg<DK, DV>::smem;
  static OptIn opted;  // per device, never per launch
  if (const int err = opt_in_smem(flash_bwd_bf16_kernel<DK, DV>, smem, opted)) return err;
  const long long rows = (long long)batch * p.hq * p.sq;
  flash_bwd_delta_bf16_kernel<DV><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
      o, p.dout, delta, p.hq, p.sq, rows, os, p.dos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  int e = encode_map(&tq, p.q, batch, p.hq, p.sq, DK, p.qs.b, p.qs.h, p.qs.s, kB);
  if (!e) e = encode_map(&tk, p.k, batch, p.hkv, p.sk, DK, p.ks.b, p.ks.h, p.ks.s, kB);
  if (!e) e = encode_map(&tv, p.v, batch, p.hkv, p.sk, DV, p.vs.b, p.vs.h, p.vs.s, kB);
  if (!e) e = encode_map(&tdo, p.dout, batch, p.hq, p.sq, DV, p.dos.b, p.dos.h, p.dos.s, kB);
  if (e) return e;
  const int blocks = (n_items + Cfg<DK, DV>::kItems - 1) / Cfg<DK, DV>::kItems;
  flash_bwd_bf16_kernel<DK, DV><<<blocks, Cfg<DK, DV>::kBlock, smem, stream>>>(p, tq, tk, tv,
                                                                               tdo);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dq (batch, hq, sq, hd); o, dO (batch, hq, sq, vd); k, dk (batch, hkv,
// sk, hd); v, dv (batch, hkv, sk, vd); all bf16, each addressed by its
// (batch, head, sequence) strides in elements with the head dim contiguous,
// pointers and strides 16-byte aligned; lse (the forward's) and the scratch
// delta (batch, hq, sq) contiguous f32; (hd, vd) one of (16, 16), (32, 32),
// (56, 56), (64, 64), (80, 80), (112, 112), (128, 128), (192, 128), (256,
// 256); hq a multiple of hkv; `items` the wrapper's work list at the 64-row
// tile, n_items int4s (`backward.work_list`), which must cover every output
// row.  Launches two kernels on `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_bf16_launch(
    const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
    const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* delta, const void* items, int n_items,
    int batch, int hq, int hkv, int sq, int sk, int hd, int vd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, int causal, int window, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 || n_items < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.items = static_cast<const int4*>(items);
  p.n_items = n_items;
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.sk = sk; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.scale = scale;
  p.qs = {q_sb, q_sh, q_ss}; p.ks = {k_sb, k_sh, k_ss}; p.vs = {v_sb, v_sh, v_ss};
  p.dos = {do_sb, do_sh, do_ss}; p.dqs = {dq_sb, dq_sh, dq_ss};
  p.dks = {dk_sb, dk_sh, dk_ss}; p.dvs = {dv_sb, dv_sh, dv_ss};
  const Strides os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_BWD_CASE(DK, DV) \
  if (hd == DK && vd == DV) return launch<DK, DV>(p, o, os, delta, batch, n_items, s);
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
