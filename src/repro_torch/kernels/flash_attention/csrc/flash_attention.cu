// Forward flash attention for Hopper (sm_90a), fp32 in and out, computed on
// the tensor cores with split-TF32 operands.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::_body (the Pallas TPU
// kernel launched by flash_attention_fwd_pallas):
//     o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]
// over the keys j allowed by the mask (j < Sk; j <= i when causal;
// i - j < window when window > 0), with scale = hd^-0.5, the online-softmax
// state (m, l, acc) and P in f32, the reference's m_safe / corr rules, a fully
// masked row giving 0, and the final divide by max(l, 1e-30).
//
// What bounds it on this card: operations.  QK^T and P.V are 4 * hd FLOPs per
// (q row, key) pair inside the band.  On the fp32 FMA units that is 67 TFLOP/s,
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
//   - q (64 x hd) is staged once; K and V (32 x hd each) go through a ring of
//     two stages filled by cp.async, so the next step's tiles load while this
//     one computes.  Rows are padded by 4 floats and every fragment load is a
//     float4 free of bank conflicts.  hd 256 takes 216,064 B of shared memory,
//     so one block runs per SM.
//   - 8 warps work in pairs on 16 q rows (one warp of 16 rows alone cannot
//     hide the latency of its dependent mma chains).  Each warp of a pair sums
//     QK^T over half of hd; the two halves are added through shared memory
//     (in the same order by both, so both hold the same scores), both run the
//     same online softmax, and each computes P.V for its half of the output
//     columns (64 accumulator registers a thread at hd 256).
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
// GQA is the kv head index h // g: a shared kv head is read by its g q heads
// from L2, never copied per head.  Tensors are addressed by (batch, head,
// sequence) strides with hd contiguous, so the model's (B, S, H, hd) layout
// is read and written in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;                  // padded smem row, floats
  static constexpr int DC = HD / 2 < 32 ? HD / 2 : 32;  // column chunk of a fragment load
  static constexpr int E = DC / 4;                   // floats a thread loads per row and chunk
  static constexpr int NT = DC / 8;                  // k-steps (QK^T) / n-tiles (P.V) per chunk
  static constexpr int NH = HD / DC / 2;             // chunks of each warp of a pair
  static constexpr int kQ = kBq * LD;                // floats of the q tile
  static constexpr int kKV = kBk * LD;               // floats of one K or V tile
  static constexpr int kX = kWarps * 16 * 32;        // floats of the score exchange
  static constexpr int smem = (int)sizeof(float) * (kQ + 2 * kStages * kKV + kX);
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

// the two warps of a pair (16 q rows) meet here; barrier 0 is __syncthreads
__device__ __forceinline__ void pair_sync(int row_warp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + row_warp) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq, int sq,
                 int sk, int group, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, DC = C::DC, E = C::E, NT = C::NT, NH = C::NH;
  extern __shared__ float4 smem4[];
  float* qsh = reinterpret_cast<float*>(smem4);  // (kBq, LD)
  float* kvsh = qsh + C::kQ;                     // per stage: K (kBk, LD), V (kBk, LD)
  float* xsh = kvsh + 2 * kStages * C::kKV;      // per warp: 16 scores x 32 lanes

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp % kRowWarps;  // the warp's 16 q rows
  const int hf = warp / kRowWarps;  // its half of hd: chunks [hf * NH, hf * NH + NH)
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

  for (int idx = tid; idx < kBq * HD / 4; idx += kThreads) {
    const int r = idx / (HD / 4), c4 = idx - r * (HD / 4);
    const bool ok = q0 + r < sq;
    cp_async16(qsh + r * LD + 4 * c4, qg + (ok ? q0 + r : 0) * qs.s + 4 * c4, ok);
  }
  auto load_kv = [&](int jb, int st) {
    float* ksh = kvsh + st * 2 * C::kKV;
    float* vsh = ksh + C::kKV;
    const int k0 = jb * kBk;
    for (int idx = tid; idx < kBk * HD / 4; idx += kThreads) {
      const int r = idx / (HD / 4), c4 = idx - r * (HD / 4);
      const bool ok = k0 + r < sk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(ksh + r * LD + 4 * c4, kg + row * ks.s + 4 * c4, ok);
      cp_async16(vsh + r * LD + 4 * c4, vg + row * vs.s + 4 * c4, ok);
    }
  };
  if (n_kv > 0) load_kv(jb0, 0);
  cp_commit();

  const int r0 = q0 + 16 * rw;  // the warp's first q row
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[NH * NT][4];  // P.V n-tile (c - hf * NH) * NT + i; rows g, g + 8
#pragma unroll
  for (int n = 0; n < NH * NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      const float* ksh = kvsh + st * 2 * C::kKV;
      const float* vsh = ksh + C::kKV;

      // s = q k^T for rows (g, g + 8), keys 8j + 2t + {0, 1}: this warp sums
      // its half of hd, then adds the other half from its pair
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* qa = qsh + (16 * rw + g) * LD + hf * NH * DC + t * E;
      const float* kb = ksh + g * LD + hf * NH * DC + t * E;
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        float xa[E], xb[E];
        load_row(xa, qa + c * DC);
        load_row(xb, qa + 8 * LD + c * DC);
        uint32_t ab[NT][4], as[NT][4];
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          split(xa[2 * kk], ab[kk][0], as[kk][0]);
          split(xb[2 * kk], ab[kk][1], as[kk][1]);
          split(xa[2 * kk + 1], ab[kk][2], as[kk][2]);
          split(xb[2 * kk + 1], ab[kk][3], as[kk][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float y[E];
          load_row(y, kb + 8 * j * LD + c * DC);
#pragma unroll
          for (int kk = 0; kk < NT; ++kk) mma3(s[j], ab[kk], as[kk], y[2 * kk], y[2 * kk + 1]);
        }
      }
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
      for (int n = 0; n < NH * NT; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }

      // acc += P V over this warp's half of hd: the A-fragment of k-tile j is
      // s[j] (key 2t -> column t, key 2t + 1 -> column t + 4); V n-tile i of
      // chunk c, column g is hd column c * DC + NT * g + i
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pb[4], pl[4];
        split(s[j][0], pb[0], pl[0]);
        split(s[j][2], pb[1], pl[1]);
        split(s[j][1], pb[2], pl[2]);
        split(s[j][3], pb[3], pl[3]);
        const float* v0 = vsh + (8 * j + 2 * t) * LD + hf * NH * DC + NT * g;
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          float y0[NT], y1[NT];
          load_row(y0, v0 + c * DC);
          load_row(y1, v0 + LD + c * DC);
#pragma unroll
          for (int i = 0; i < NT; ++i) mma3(acc[c * NT + i], pb, pl, y0[i], y1[i]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st and the exchange
  }
  cp_wait<0>();

  // thread (g, t) holds, per chunk c of its half, hd columns
  // c * DC + 2t * NT + [0, 2 NT)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    float* orow = o + bi * os.b + h * os.h + row * os.s + hf * NH * DC + 2 * t * NT;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      float out[2 * NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        out[i] = acc[c * NT + i][2 * r] / denom;
        out[NT + i] = acc[c * NT + i][2 * r + 1] / denom;
      }
      store_row(orow + c * DC, out);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int batch, int hq,
           int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::smem;
  // the opt-in above 48 KB is set once per process and instantiation
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const dim3 grid(batch * hq, (sq + kBq - 1) / kBq);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, hq, sq, sk, hq / hkv, qs, ks, vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (batch, hq, sq, hd), k/v (batch, hkv, sk, hd), o like q, each addressed
// by its (batch, head, sequence) strides in elements with hd contiguous;
// pointers and strides 16-byte aligned; hd in {16, 32, 64, 128, 256}; hq a
// multiple of hkv.  Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const float* q, const float* k, const float* v, float* o, int batch,
    int hq, int hkv, int sq, int sk, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal, window, scale, s);
    case 32: return launch<32>(q, k, v, o, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, o, batch, hq, hkv, sq, sk, qs, ks, vs, os, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
