// Forward flash attention for Hopper (sm_90a) at bf16 in and out, on
// warpgroup `wgmma` (`flash_attention_bf16_launch`).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::_body (the Pallas TPU
// kernel launched by flash_attention_fwd_pallas) at bf16 input, the function
// of the fp32 kernel in `flash_attention.cu`:
//     o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]
// over the keys j the mask allows (j < Sk; j <= i when causal; i - j <
// window when window > 0), scale = hd^-0.5 (q's head dim; MLA's v and o are
// 128 wide beside q and k's 192), with what the Pallas kernel does at bf16:
// f32 scores and softmax statistics with the reference's m_safe / corr
// rules, P rounded to bf16 for P.V while l sums the unrounded f32 P, f32
// accumulation, o rounded to bf16 once, a fully masked row giving 0 and the
// log-sum-exp written when asked (0 for a row that sees no key).  A bf16
// product is exact in f32, so each product is the reference's f32 dot of
// upcast values up to the order of its sum.  The running max is taken on the
// raw scores and scaled once (rounding is monotone, so it is the max of the
// scaled scores), and P = 2^(s scale log2(e) - m log2(e)), one FMA and one
// ex2 a score; the reference's exp(s scale - m) is a rounding or two apart
// in f32, far under P's bf16 rounding.
//
// What bounds it on this card: operations.  2 (hd + vd) FLOPs a (q row,
// key) pair of the band, at the 989 TFLOP/s bf16 tensor-core peak.  Both
// products run on `wgmma.mma_async` (`hopper.cuh`): S = q K^T with q and K
// from shared memory, then P.V with P from registers (the S accumulators
// rounded in place into A fragments, no shuffle) and V read MN-major.
//
// Layout.  A block owns one (batch, q head) and 128 q rows, 64 for each of
// its two warpgroups, and walks the kv band in steps of 64 keys:
//   - From head dim 80 to 192 (`solo`) each warpgroup walks its own 64
//     rows' band with a q tile and a ring of two K / V stages of its own in
//     shared memory and its own named barrier, so the two drift apart and
//     one's softmax runs beside the other's products; (192, 128) takes
//     216,064 B.  At 64 and below (51,200 B, two blocks an SM) and at 256
//     (198,656 B) the two share the 128-row q tile and one ring, one
//     barrier a step, which halves the K / V streamed a q row.
//   - The copies are TMA (`hopper.cuh`): one thread issues a step's K and V
//     boxes into the stage the team has just released and the readers wait
//     on the stage's mbarrier, so the next step's copy is in flight while
//     this one computes.
//   - Each warpgroup holds its 64 rows' online-softmax state (m, l) and the
//     64 x vd output accumulator in registers (128 a thread at vd 256) and
//     updates them on the accumulator fragments: the row max and sum over
//     the four threads that hold a row (two shuffles).
//   - The band skip is the loop's bounds; a warpgroup whose 64 rows see no
//     key of a step skips its products (which leaves (m, l, o) exactly
//     unchanged), and the mask is evaluated only on a step that crosses the
//     band's edge or Sk.  Causal q blocks run heaviest first: over all
//     heads, or a (batch, head) at a time where the wrapper asks
//     (`kernel.head_major`: K and V outgrow the L2), so that the blocks in
//     flight share a few heads' K / V in L2.
//   - A head dim that is not a multiple of 64 (the MTP block's 56, 80, 112)
//     arrives zero-filled past its end (the tensor map's boxes), so it adds
//     nothing to QK^T; P.V's N is the true vd, and nothing past it is
//     stored.  The model's tensors are read and written in place by their
//     (batch, head, sequence) strides; GQA is the kv head index h // g, a
//     shared kv head read by its g q heads from L2.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace hopper;

constexpr int kWG = 2;               // warpgroups a block, 64 q rows each
constexpr int kThreads = 128 * kWG;
constexpr int kBq = 64 * kWG;        // q rows a block
constexpr int kBk = 64;              // keys a kv step

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

// DK: the head dim of q and K (QK^T's reduction); DV: that of V and o
template <int DK, int DV>
struct Cfg {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "the head dims must be multiples of 8");
  static constexpr int NK = (DK + 15) / 16;                  // QK^T's 16-wide k-steps
  static constexpr int AK = (DK + 63) / 64, AV = (DV + 63) / 64;  // 64-column atoms a row
  static constexpr int kK = kBk * 128 * AK, kV = kBk * 128 * AV;  // bytes of a K and a V tile
  // from 80 to 192 wide, each warpgroup walks its own 64 rows' band with a
  // ring of its own (`solo`: the two drift apart, one's softmax beside the
  // other's products); at 64 and below (two blocks an SM) and at 256 they
  // share the 128-row q tile and one ring, which halves the K / V they
  // stream a row
  static constexpr bool kSolo = DK > 64 && DK <= 192;
  static constexpr int kQR = kSolo ? 64 : kBq;               // rows of a q tile
  static constexpr int kQ = kQR * 128 * AK;                  // bytes of the q tile
  // a q tile, its ring and three mbarriers (q, stage 0, stage 1)
  static constexpr int kBars = kQ + 2 * (kK + kV), kRegion = kBars + 1024;
  static constexpr int smem = (kSolo ? 2 : 1) * kRegion + 1024;  // + the base's alignment
  static_assert(smem <= 232448, "over sm_90's opt-in shared memory per block");
};

struct Args {
  const CUtensorMap *q, *k, *v;  // the kernel's tensor maps (parameter space)
  bf16* o;
  float* lse;                    // null: not written
  long long oss, lse0;           // o's row stride; lse's (batch, head) offset
  int bi, h, hk, sq, sk, causal, window;
  float scale;
};

// the walk of one team -- THREADS threads (two warpgroups or one) sharing a
// q tile of QR rows from row qt0 and a ring of K / V stages at `ring`, its
// barrier `barid`, its mbarriers at `bars` -- over the kv band of the
// tile's rows; this warpgroup owns rows qt0 + wrow .. qt0 + wrow + 63
template <int DK, int DV, int THREADS, int QR>
__device__ __forceinline__ void attend(const Args& a, uint32_t qsh, uint32_t ring, uint32_t bars,
                                       int qt0, int wrow, int tid, int barid) {
  using C = Cfg<DK, DV>;
  // the band of kv steps the tile's rows can see
  const int kv_end = a.causal ? min(a.sk, qt0 + QR) : a.sk;
  const int kv_begin = a.window > 0 ? max(0, qt0 - a.window + 1) : 0;
  const int jb0 = kv_begin / kBk;
  const int n_kv = max(0, (kv_end + kBk - 1) / kBk - jb0);
  const uint32_t qbar = bars, full = bars + 8;  // stage st's barrier at full + 8 st
  auto load_kv = [&](int jb, int st) {  // by one thread
    const uint32_t ksh = ring + st * (C::kK + C::kV);
    mbar_expect(full + 8 * st, C::kK + C::kV);
    tma_tile<kBk, C::AK>(ksh, a.k, full + 8 * st, jb * kBk, a.hk, a.bi);
    tma_tile<kBk, C::AV>(ksh + C::kK, a.v, full + 8 * st, jb * kBk, a.hk, a.bi);
  };
  if (n_kv > 0) {  // else every row sees no key: the stores below write zeros
    if (tid == 0) {
      mbar_init(qbar, 1);
      mbar_init(full, 1);
      mbar_init(full + 8, 1);
      mbar_init_fence();
    }
    bar(barid, THREADS);
    if (tid == 0) {
      mbar_expect(qbar, C::kQ);
      tma_tile<QR, C::AK>(qsh, a.q, qbar, qt0, a.h, a.bi);
      load_kv(jb0, 0);
    }
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int w0 = qt0 + wrow;                        // the warpgroup's first row
  const int rbase = w0 + 16 * warp + (lane >> 2);   // this thread's rows: rbase, rbase + 8
  const int cq = 2 * (lane & 3);                    // its first column of each 8-wide group
  const float sl = a.scale * kLog2e;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DV / 2];
#pragma unroll
  for (int e = 0; e < DV / 2; ++e) acc[e] = 0.f;
  if (n_kv > 0) mbar_wait(qbar, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    bar(barid, THREADS);  // the team is done with stage st ^ 1 (step it - 1)
    if (tid == 0 && it + 1 < n_kv) load_kv(jb0 + it + 1, st ^ 1);
    mbar_wait(full + 8 * st, (it >> 1) & 1);  // this step's K and V have landed

    const int k0 = (jb0 + it) * kBk;
    const bool skip = w0 >= a.sq || k0 >= a.sk || (a.causal && k0 > w0 + 63) ||
                      (a.window > 0 && w0 - (k0 + kBk - 1) >= a.window);
    if (skip) continue;  // the same for the whole warpgroup
    const uint32_t ksh = ring + st * (C::kK + C::kV), vsh = ksh + C::kK;

    // s = q K^T: element e is row rbase + 8 ((e / 2) % 2), key k0 + 8 (e / 4) + cq + e % 2
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::NK; ++kk)
      Mma<64>::ss<0>(s, desc_k<QR>(qsh, wrow, kk), desc_k<kBk>(ksh, 0, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // the mask where the step crosses the band's edge or Sk, then the
    // online-softmax update of rows rbase (r = 0) and rbase + 8 (r = 1) on
    // the raw scores: the max of the scaled scores is the scaled max
    // (rounding is monotone), and P = 2^(s scale log2(e) - m log2(e))
    const bool inside = k0 + kBk <= a.sk && (!a.causal || k0 + kBk - 1 <= w0) &&
                        (a.window <= 0 || w0 + 63 - k0 < a.window);
    if (!inside) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = rbase + 8 * ((e >> 1) & 1), key = k0 + 8 * (e >> 2) + cq + (e & 1);
        bool ok = key < a.sk;
        if (a.causal) ok = ok && key <= row;
        if (a.window > 0) ok = ok && row - key < a.window;
        if (!ok) s[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float nm[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * a.scale);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      corr[r] = isfinite(m_run[r]) ? ex2((m_run[r] - m_safe) * kLog2e) : 0.f;
      m_run[r] = m_new;
      nm[r] = -m_safe * kLog2e;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = ex2(fmaf(s[e], sl, nm[(e >> 1) & 1]));  // 2^-inf = 0 where masked
      ps[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l_run[r] = l_run[r] * corr[r] + ps[r];  // l sums the unrounded P
    }
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) acc[e] *= corr[(e >> 1) & 1];

    // acc += bf16(P) V: P's A fragments are the score accumulators in place
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<DV>::template rs<1>(acc, pa[kk], desc_mn<kBk>(vsh, kk, 0), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  }

  // the log-sum-exp of each row's scaled scores, (batch, hq, sq) contiguous:
  // log(l) + m, 0 for a row that sees no key; nothing here feeds o
  if (a.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rbase + 8 * r;
      if (row >= a.sq) continue;
      a.lse[a.lse0 + row] =
          (l_run[r] > 0.f ? logf(l_run[r]) : 0.f) + (isfinite(m_run[r]) ? m_run[r] : 0.f);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rbase + 8 * r;
    if (row >= a.sq) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    bf16* orow = a.o + row * a.oss + cq;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int hq, int sq, int sk, int group, long long oss,
                      long long osh, long long osb, int causal, int window, float scale,
                      int head_major) {
  using C = Cfg<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  // a (batch, head) and one of its nqb q blocks: heads outer with
  // `head_major` (the blocks in flight then share a few heads' K / V in
  // L2), else q blocks outer (every head's heaviest block first)
  const int nqb = (sq + kBq - 1) / kBq, nbh = gridDim.x / nqb;
  const int bh = head_major ? blockIdx.x / nqb : blockIdx.x % nbh;
  const int qi = head_major ? blockIdx.x % nqb : blockIdx.x / nbh;
  const int h = bh % hq, bi = bh / hq;
  const int q0 = (causal ? nqb - 1 - qi : qi) * kBq;  // the block's first q row
  const Args a{&tq, &tk, &tv, o + bi * osb + h * osh, lse, oss, ((long long)bi * hq + h) * sq,
               bi, h, h / group, sq, sk, causal, window, scale};
  if constexpr (C::kSolo) {  // warpgroup w: rows q0 + 64 w .. + 63, in its own region
    if (q0 + 64 * wg >= sq) return;
    const uint32_t region = base + wg * C::kRegion;
    attend<DK, DV, 128, 64>(a, region, region + C::kQ, region + C::kBars, q0 + 64 * wg, 0,
                            tid & 127, 1 + wg);
  } else {
    attend<DK, DV, kThreads, kBq>(a, base, base + C::kQ, base + C::kBars, q0, 64 * wg, tid, 1);
  }
}

template <int DK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int batch, int hq,
           int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, int head_major, float scale, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  constexpr int smem = C::smem;
  static OptIn opted;  // per device, never per launch
  if (const int err = opt_in_smem(flash_fwd_bf16_kernel<DK, DV>, smem, opted)) return err;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, batch, hq, sq, DK, qs.b, qs.h, qs.s, C::kQR);
  if (!err) err = encode_map(&tk, k, batch, hkv, sk, DK, ks.b, ks.h, ks.s, kBk);
  if (!err) err = encode_map(&tv, v, batch, hkv, sk, DV, vs.b, vs.h, vs.s, kBk);
  if (err) return err;
  const long long blocks = (long long)batch * hq * ((sq + kBq - 1) / kBq);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_bf16_kernel<DK, DV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, o, lse, hq, sq, sk, hq / hkv, os.s, os.h, os.b, causal, window, scale,
      head_major);
  return (int)cudaGetLastError();
}

}  // namespace

// q (batch, hq, sq, hd), k (batch, hkv, sk, hd), v (batch, hkv, sk, vd), o
// (batch, hq, sq, vd), bf16, each addressed by its (batch, head, sequence)
// strides in elements with the head dim contiguous, pointers and strides
// 16-byte aligned; lse, when not null, (batch, hq, sq) contiguous f32 (the
// backward's input); (hd, vd) one of (16, 16), (32, 32), (56, 56), (64, 64),
// (80, 80), (112, 112), (128, 128), (192, 128), (256, 256); hq a multiple of
// hkv; head_major orders the blocks a (batch, head) at a time.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int flash_attention_bf16_launch(
    const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int batch, int hq,
    int hkv, int sq, int sk, int hd, int vd, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, int causal, int window,
    int head_major, float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(DK, DV)                                                                    \
  if (hd == DK && vd == DV)                                                                   \
    return launch<DK, DV>(q, k, v, o, lse, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal,    \
                          window, head_major, scale, s);
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
