// Forward flash attention for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::_body (the Pallas TPU
// kernel launched by flash_attention_fwd_pallas):
//     o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // g, j]) v[b, h // g, j]
// over the keys j allowed by the mask (j < Sk; j <= i when causal;
// i - j < window when window > 0), with scale = hd^-0.5, the online-softmax
// state (m, l, acc) in f32, a fully masked row giving 0, and the final divide
// by max(l, 1e-30) -- the Pallas body's exact semantics.
//
// The TPU kernel runs the kv blocks as a sequential grid axis with (m, l, acc)
// in VMEM scratch.  Here one thread block owns one (batch, q head, 64-row q
// block) and walks the kv blocks in a loop; the band skip is the loop's bounds
// (computed from causal and window), not a per-tile predicate.  Per block:
//   - the scaled q tile (64 x hd) sits in shared memory for the whole loop;
//   - per 32-key block, K is staged transposed (hd x 32) and V as is (32 x hd);
//   - four threads own one q row: each computes 8 of the row's 32 scores from
//     shared memory into registers, the row max and row sum are taken with
//     warp shuffles, and P stays in registers (never shared or device memory);
//   - P . V is accumulated into the row's (hd / 4)-column slice each thread
//     holds in registers, the P values of the row's other 8-column groups
//     fetched from the neighbouring lanes by shuffle.
// GQA is the kv head index h // g: a shared kv head is read by its g q heads
// from L2, never copied per head.  Tensors are addressed by (batch, head,
// sequence) strides with hd contiguous, so the model's (B, S, H, hd) layout
// is read and written in place, without a transpose.
//
// What bounds it on this card: operations.  Scores and P.V are 4 * hd FLOPs
// per (q row, key) pair inside the band, on the fp32 FMA units (the reference
// computes in f32; TF32 would break parity): 67 TFLOP/s.  This is a simple
// SIMT kernel; tensor cores (wgmma) and TMA staging are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBq = 64;  // q rows per block: 4 threads a row
constexpr int kBk = 32;  // keys per kv step: 8 per thread

struct Strides {
  long long b, h, s;  // elements between batches, heads and sequence rows
};

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (kBq * (HD + 4) + HD * kBk + kBk * HD);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int group, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale) {
  constexpr int QS = HD + 4;  // padded q row: the 8 rows of a warp hit
                              // distinct banks
  constexpr int C4 = HD / 4;  // float4 columns of a row
  constexpr int T = HD / 16;  // float4 accumulator chunks per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qsh = smem;               // (kBq, QS), scaled q
  float* kt = qsh + kBq * QS;      // (HD, kBk), K transposed
  float* vsh = kt + HD * kBk;      // (kBk, HD)

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = tid >> 2, part = tid & 3;
  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + bi * qs.b + h * qs.h;
  const float* kb = k + bi * ks.b + hk * ks.h;
  const float* vb = v + bi * vs.b + hk * vs.h;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < kBq * C4; idx += kThreads) {
    const int r = idx / C4, c4 = idx - r * C4;
    float4 val = zero4;
    if (q0 + r < sq) {
      val = *reinterpret_cast<const float4*>(qb + (q0 + r) * qs.s + 4 * c4);
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    *reinterpret_cast<float4*>(qsh + r * QS + 4 * c4) = val;
  }

  // band of kv blocks this q block can see
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBq);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int jb_begin = kv_begin / kBk;
  const int jb_end = (kv_end + kBk - 1) / kBk;

  const int qp = q0 + row;
  float m_run = -INFINITY, l_run = 0.f;
  float4 acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = zero4;

  for (int jb = jb_begin; jb < jb_end; ++jb) {
    const int k0 = jb * kBk;
    __syncthreads();  // the previous step is done with kt and vsh
    for (int c4 = tid >> 5; c4 < C4; c4 += kThreads / 32) {
      const int j = lane;
      float4 val = zero4;
      if (k0 + j < sk)
        val = *reinterpret_cast<const float4*>(kb + (k0 + j) * ks.s + 4 * c4);
      kt[(4 * c4 + 0) * kBk + j] = val.x;
      kt[(4 * c4 + 1) * kBk + j] = val.y;
      kt[(4 * c4 + 2) * kBk + j] = val.z;
      kt[(4 * c4 + 3) * kBk + j] = val.w;
    }
    for (int idx = tid; idx < kBk * C4; idx += kThreads) {
      const int j = idx / C4, c4 = idx - j * C4;
      float4 val = zero4;
      if (k0 + j < sk)
        val = *reinterpret_cast<const float4*>(vb + (k0 + j) * vs.s + 4 * c4);
      *reinterpret_cast<float4*>(vsh + j * HD + 4 * c4) = val;
    }
    __syncthreads();

    // scores s[jj] = q[row] . k[k0 + part*8 + jj], summed over d in order
    float s[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj] = 0.f;
    const float* qrow = qsh + row * QS;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
      const float qc[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* kr = kt + (c + cc) * kBk + part * 8;
        const float4 ka = *reinterpret_cast<const float4*>(kr);
        const float4 kb4 = *reinterpret_cast<const float4*>(kr + 4);
        s[0] = fmaf(qc[cc], ka.x, s[0]);
        s[1] = fmaf(qc[cc], ka.y, s[1]);
        s[2] = fmaf(qc[cc], ka.z, s[2]);
        s[3] = fmaf(qc[cc], ka.w, s[3]);
        s[4] = fmaf(qc[cc], kb4.x, s[4]);
        s[5] = fmaf(qc[cc], kb4.y, s[5]);
        s[6] = fmaf(qc[cc], kb4.z, s[6]);
        s[7] = fmaf(qc[cc], kb4.w, s[7]);
      }
    }

    // mask, then the online-softmax update of this row's (m, l, acc)
    unsigned ok = 0u;
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int kp = k0 + part * 8 + jj;
      bool keep = kp < sk;
      if (causal) keep = keep && kp <= qp;
      if (window > 0) keep = keep && qp - kp < window;
      if (keep) {
        ok |= 1u << jj;
        mx = fmaxf(mx, s[jj]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float p[8];
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      p[jj] = (ok >> jj) & 1u ? expf(s[jj] - m_safe) : 0.f;
      psum += p[jj];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = isfinite(m_run) ? expf(m_run - m_safe) : 0.f;
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      acc[t].x *= corr; acc[t].y *= corr; acc[t].z *= corr; acc[t].w *= corr;
    }

    // acc += P . V over the 32 keys in order; key sp*8 + jj's P value lives
    // in lane (row's first lane + sp), register jj
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p[jj], (lane & ~3) | sp);
        const float* vrow = vsh + (sp * 8 + jj) * HD + part * 4;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * t);
          acc[t].x = fmaf(pj, vv.x, acc[t].x);
          acc[t].y = fmaf(pj, vv.y, acc[t].y);
          acc[t].z = fmaf(pj, vv.z, acc[t].z);
          acc[t].w = fmaf(pj, vv.w, acc[t].w);
        }
      }
    }
  }

  if (qp < sq) {
    const float denom = fmaxf(l_run, 1e-30f);
    float* orow = o + bi * os.b + h * os.h + qp * os.s + part * 4;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float4 r = acc[t];
      r.x /= denom; r.y /= denom; r.z /= denom; r.w /= denom;
      *reinterpret_cast<float4*>(orow + 16 * t) = r;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int batch,
           int hq, int hkv, int sq, int sk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBq - 1) / kBq, hq, batch);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, sq, sk, hq / hkv, qs, ks, vs, os, causal, window, scale);
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
