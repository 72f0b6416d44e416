// Depthwise causal conv1d + bias + optional SiLU for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/conv1d_fused/kernel.py::_body (the Pallas TPU
// kernel launched by conv1d_fused_call): the Mamba2 short conv and the
// registry's conv1d_fused algorithm,
//     out[b, l, c] = act(sum_{i<K} x[b, l - (K-1) + i, c] * w[i, c] + bias[c])
// with x[b, l < 0, c] = 0 (causal front pad).
//
// One thread is one channel of one L-strip of one sequence: grid =
// (ceil(D / 128), ceil(L / strip), B), 128 threads.  The thread keeps its K
// taps and its bias in registers (the TPU kernel's stationary VMEM blocks),
// reads the K-1 halo rows before its strip once, then slides a K-row register
// window down the strip, so every input row is read once per strip and
// neighbouring threads read neighbouring channels (coalesced rows).  The
// front pad is never materialized: rows before 0 read as zero.  The input row
// stride is an argument, so a column slice of a wider activation (Mamba's
// xBC inside zxbcdt) is read in place.
//
// What bounds it on this card: bytes.  2K FLOPs per element against 8 bytes
// moved (one read, one write), so at the served shape (B=4, L=768, D=4352)
// the floor is 2*B*L*D*4 B / 3.35 TB/s; bias and SiLU are fused into the
// same pass, which is the whole point of the fusion.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
conv1d_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int seq, int d, long long x_row_stride, int strip,
                    int silu) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const int l0 = blockIdx.y * strip;
  const int l1 = min(l0 + strip, seq);
  const long long row0 = (long long)blockIdx.z * seq;
  float taps[K];
#pragma unroll
  for (int i = 0; i < K; ++i) taps[i] = w[i * d + c];
  const float b = bias[c];
  // win[K-1-j] holds x[l - j] for the current row l; win[1..K-1] start as
  // the halo rows l0-(K-1) .. l0-1
  float win[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int l = l0 - (K - 1) + i;
    win[i + 1] = l >= 0 ? x[(row0 + l) * x_row_stride + c] : 0.f;
  }
#pragma unroll 4
  for (int l = l0; l < l1; ++l) {
#pragma unroll
    for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
    win[K - 1] = x[(row0 + l) * x_row_stride + c];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc = fmaf(win[i], taps[i], acc);
    acc += b;
    if (silu) acc = acc * (1.f / (1.f + expf(-acc)));
    out[(row0 + l) * d + c] = acc;
  }
}

template <int K>
void launch(const float* x, const float* w, const float* b, float* out,
            int batch, int seq, int d, long long x_row_stride, int strip,
            int silu, cudaStream_t stream) {
  dim3 grid((d + kThreads - 1) / kThreads, (seq + strip - 1) / strip, batch);
  conv1d_fused_kernel<K><<<grid, kThreads, 0, stream>>>(
      x, w, b, out, seq, d, x_row_stride, strip, silu);
}

}  // namespace

// x: (batch, seq, d) rows x_row_stride floats apart (channels contiguous);
// w: (k, d); b: (d,); out: (batch, seq, d) contiguous.  k in 1..8.  Launches
// on `stream`; returns cudaGetLastError() right after the launch.
extern "C" int conv1d_fused_launch(const float* x, const float* w,
                                   const float* b, float* out, int batch,
                                   int seq, int d, long long x_row_stride,
                                   int k, int strip, int silu, void* stream) {
  if (batch < 1 || seq < 1 || d < 1 || strip < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 2: launch<2>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 3: launch<3>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 4: launch<4>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 5: launch<5>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 6: launch<6>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 7: launch<7>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    case 8: launch<8>(x, w, b, out, batch, seq, d, x_row_stride, strip, silu, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
