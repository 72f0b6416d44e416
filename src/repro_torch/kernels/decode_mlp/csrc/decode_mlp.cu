// Weight-stationary fused SwiGLU decode MLP for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/decode_mlp/kernel.py::_body (the Pallas TPU
// kernel launched by decode_mlp_call):
//     y = (silu(x W1) * (x W3)) W2,   x (B, d), W1/W3 (d, f), W2 (f, d),
// with the hidden h = silu(xW1) * xW3 never written to device memory.
//
// The TPU kernel walks d_ff blocks as a sequential grid axis and carries one
// f32 accumulator across them.  Here the d_ff blocks run in parallel, one
// thread block per 32 columns of d_ff (grid = ceil(f / 32)):
//   1. the x rows (up to 8 at a time) are staged in shared memory;
//   2. each warp sums x . W1[:, j] and x . W3[:, j] over its eighth of the d
//      rows for the block's 32 columns j (one 128-byte row segment of W1 and
//      W3 per warp step, coalesced), the eight warp partials are summed in a
//      fixed order, and h = silu(h1) * h3 stays in shared memory;
//   3. the block multiplies its (rows, 32) slice of h by the matching 32 rows
//      of W2 and writes a partial (rows, d) result into scratch.
// A second kernel sums the partials over the d_ff blocks in block order.  No
// float atomics: the result is the same from run to run.
//
// What bounds it on this card: bytes.  At decode B is a handful of rows, so
// the 3*d*f weights dominate what moves (gemma3-1b: 3*1152*6912*4 B = 95.6
// MB, 28.5 us at 3.35 TB/s); each weight is read once per 8 rows of x.  The
// partials add 2 * ceil(f/32) * B * d * 4 B of traffic, mostly to L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFb = 32;  // d_ff columns per block: one warp-width
constexpr int kRb = 8;   // rows of x per pass over the weights

__global__ void __launch_bounds__(kThreads)
decode_mlp_partial(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w3, const float* __restrict__ w2,
                   float* __restrict__ part, int batch, int d, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                         // (kRb, d)
  float* red1 = xs + kRb * d;               // (kWarps, kRb, kFb)
  float* red3 = red1 + kWarps * kRb * kFb;  // (kWarps, kRb, kFb)
  float* hs = red3 + kWarps * kRb * kFb;    // (kRb, kFb)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kFb;
  const int j = j0 + lane;
  const int nl = min(kFb, f - j0);
  for (int b0 = 0; b0 < batch; b0 += kRb) {
    const int rb = min(kRb, batch - b0);
    __syncthreads();  // the previous pass is done with xs and hs
    for (int i = tid; i < kRb * d; i += kThreads) {
      const int r = i / d;
      xs[i] = r < rb ? x[(size_t)(b0 + r) * d + (i - r * d)] : 0.f;
    }
    __syncthreads();

    float a1[kRb], a3[kRb];
#pragma unroll
    for (int r = 0; r < kRb; ++r) a1[r] = a3[r] = 0.f;
    if (j < f) {
#pragma unroll 4
      for (int i = warp; i < d; i += kWarps) {
        const float v1 = w1[(size_t)i * f + j];
        const float v3 = w3[(size_t)i * f + j];
#pragma unroll
        for (int r = 0; r < kRb; ++r) {
          const float xv = xs[r * d + i];
          a1[r] = fmaf(xv, v1, a1[r]);
          a3[r] = fmaf(xv, v3, a3[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRb; ++r) {
      red1[(warp * kRb + r) * kFb + lane] = a1[r];
      red3[(warp * kRb + r) * kFb + lane] = a3[r];
    }
    __syncthreads();
    if (tid < kRb * kFb) {
      const int r = tid / kFb, l = tid % kFb;
      float h1 = 0.f, h3 = 0.f;
      for (int wp = 0; wp < kWarps; ++wp) {
        h1 += red1[(wp * kRb + r) * kFb + l];
        h3 += red3[(wp * kRb + r) * kFb + l];
      }
      hs[tid] = l < nl ? h1 * (1.f / (1.f + expf(-h1))) * h3 : 0.f;
    }
    __syncthreads();

    for (int c = tid; c < d; c += kThreads) {
      float acc[kRb];
#pragma unroll
      for (int r = 0; r < kRb; ++r) acc[r] = 0.f;
      for (int l = 0; l < nl; ++l) {
        const float v = w2[(size_t)(j0 + l) * d + c];
#pragma unroll
        for (int r = 0; r < kRb; ++r) acc[r] = fmaf(hs[r * kFb + l], v, acc[r]);
      }
      for (int r = 0; r < rb; ++r)
        part[((size_t)blockIdx.x * batch + b0 + r) * d + c] = acc[r];
    }
  }
}

// out[i] = sum over d_ff blocks k, in order, of part[k, i]; i over (B, d)
__global__ void decode_mlp_reduce(const float* __restrict__ part,
                                  float* __restrict__ out, int n_blocks,
                                  int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_blocks; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

// Shared memory the partial kernel needs at model width d.
extern "C" int decode_mlp_smem_bytes(int d) {
  return (int)sizeof(float) * (kRb * d + 2 * kWarps * kRb * kFb + kRb * kFb);
}

// Number of d_ff blocks (rows of the partial scratch) at hidden width f.
extern "C" int decode_mlp_blocks(int f) { return (f + kFb - 1) / kFb; }

// x (batch, d), w1/w3 (d, f), w2 (f, d), part (ceil(f/32), batch, d) scratch,
// out (batch, d); all contiguous f32.  Launches both kernels on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int decode_mlp_launch(const float* x, const float* w1,
                                 const float* w3, const float* w2, float* part,
                                 float* out, int batch, int d, int f,
                                 void* stream) {
  if (batch < 1 || d < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = decode_mlp_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_mlp_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = decode_mlp_blocks(f);
  decode_mlp_partial<<<n_blocks, kThreads, smem, s>>>(x, w1, w3, w2, part,
                                                      batch, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = batch * d;
  decode_mlp_reduce<<<(n + 255) / 256, 256, 0, s>>>(part, out, n_blocks, n);
  return (int)cudaGetLastError();
}
