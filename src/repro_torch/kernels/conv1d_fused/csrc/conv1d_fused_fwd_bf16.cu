// The bf16 depthwise causal conv1d + bias + optional SiLU for Hopper (sm_90a),
// as a TMA-fed stream.
//
// Replaces src/repro/kernels/conv1d_fused/kernel.py::_body (the Pallas TPU
// kernel launched by conv1d_fused_call) at bf16, for K 1..8:
//     out[b, l, c] = act(sum_{i<K} x[b, l - (K-1) + i, c] * w[i, c] + bias[c])
// with x[b, l < 0, c] = 0 (causal front pad), every value upcast, the chain
// in f32 and the output rounded to bf16 once.  Each element's chain is the
// one `conv1d_fused.cu`'s bf16 entry runs (acc = 0; acc = fmaf(x, w_i, acc)
// for i = 0..K-1 in order; acc += bias; acc * (1 / (1 + expf(-acc))); one
// round to nearest), so the output is bitwise that entry's.  x is read in
// place at its row stride (mamba2's xBC slice of zxbcdt).
//
// What bounds it on this card: bytes.  x read once and y written once: 2 x 2
// B an element, 16.0 us at mamba2-1.3b's first prefill wave (B 4, L 768, D
// 4352) at 3.35 TB/s.  The chain (K FMAs, the bias, an accurate expf, an
// IEEE divide, unpack and pack) is some 25-30 instructions an element: issue
// comes close behind the bytes, so the two have to overlap.
//
// What the fp32 design's bf16 instance (`conv1d_fused_bf16_launch`, kept for
// the shapes this kernel does not take) lost to, and what this one does:
//   - Halo re-reads: a thread loaded the K-1 rows before its 8-row strip
//     beside the strip (11 rows read for 8 written at K 4, the halo from L2).
//     Here a block walks a contiguous range of rows with the K-row window in
//     registers, and the K-1 rows before a piece of its range come once, in a
//     (K-1)-row box.
//   - Short threads and many waves (1,920 blocks of one strip a thread at
//     mamba2, ~3 blocks an SM by registers): here the grid is one wave, 3
//     blocks an SM, each a channel slab of 256 over a contiguous range of the
//     slab's (sequence, 32-row segment) pairs (`stream.cuh`).
//   - Nearly empty channel blocks (1,024 channels a block: a fifth of the
//     blocks a quarter full at D 4352): slabs of 256 (D 4352 is 17 slabs).
//   - Bytes in flight tied to the walking threads' registers: here one
//     producer thread keeps 64 x 16 TMA boxes of x in flight through a ring
//     of `stages` stages (`full` / `empty` mbarriers), up to 96 KB an SM.
//   - Issue and latency: the chain of a row runs beside the chains of the
//     chunk's other 15 rows (unrolled), by 8 walking warps a block, one
//     channel a thread: 24 an SM.
//   Each warp writes its outputs into chunk buffers of its own and stores a
//   finished chunk by TMA (a 32-channel x 16-row box, two buffers deep), so
//   no barrier of the whole block holds the warps in step: they meet only at
//   the ring's `empty` barriers, up to `stages` chunks apart.  Rows and
//   channels past the tensor are clipped by the store.
//
// Shapes: K 1..8, D and the row stride multiples of 8, x and out 16-byte
// aligned (the tensor maps' rules); the wrapper sends every other bf16 shape
// to `conv1d_fused_bf16_launch`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream.cuh"
#include "smem_opt_in.cuh"

// one launch's sizes and geometry; `FwdBf16Args` in kernel.py mirrors it
struct FwdBf16Args {
  long long x_row_stride;  // values between rows of x (>= d)
  int batch, seq, d, k, silu;
  int n_slabs;   // channel slabs of kSlab
  int per_slab;  // blocks a slab
  int segs;      // segments of kSegRows rows a sequence
  int stages;    // ring stages
  int smem;      // dynamic shared memory
};

namespace {

using hopper::bf16;
using hopper::smem_u32;
using namespace conv1d_stream;  // kSlab, kChunk, kSegRows, kHaloRows, the range split

constexpr int kMaxStages = 4;
constexpr int kBlocksPerSm = 3;
constexpr int kVec = 1;  // channels a walking thread (1 or 2)
constexpr int kConsumers = kSlab / kVec;  // threads that walk
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kWarpCh = 32 * kVec;  // channels a walking warp
// a stage: x's halo rows, then x's chunk; each 4 boxes of 64 channels
constexpr int kPreBytes = kHaloRows * kSlab * 2;  // 4096
constexpr int kRowsBytes = kChunk * kSlab * 2;    // 8192
constexpr int kStageBytes = kPreBytes + kRowsBytes;
constexpr int kOutBuffers = 2;

__host__ __device__ inline int fwd_smem_bytes(int stages) {
  return stages * kStageBytes + kOutBuffers * kRowsBytes + 16 * stages + 1024;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a walking thread's V channels of one row in shared memory: one word (the
// low half the lower channel), read as f32 and written from f32
template <int V>
struct Lane;
template <>
struct Lane<1> {
  using Word = uint16_t;
  static __device__ __forceinline__ void unpack(float (&v)[1], Word w) {
    v[0] = __uint_as_float((uint32_t)w << 16);
  }
  static __device__ __forceinline__ Word pack(const float (&v)[1]) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  }
};
template <>
struct Lane<2> {
  using Word = uint32_t;
  static __device__ __forceinline__ void unpack(float (&v)[2], Word w) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ Word pack(const float (&v)[2]) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
conv1d_fwd_bf16_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mx_halo,
                       const __grid_constant__ CUtensorMap my, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, const FwdBf16Args a) {
  constexpr int H = K - 1;  // halo rows
  constexpr int V = kVec;
  using L = Lane<V>;
  using Word = typename L::Word;
  constexpr int kRowWords = 128 / sizeof(Word);  // a box row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t yb = ring + a.stages * kStageBytes;
  const uint32_t full0 = yb + kOutBuffers * kRowsBytes, empty0 = full0 + 8 * a.stages;

  const int slab = blockIdx.x / a.per_slab, kb = blockIdx.x - slab * a.per_slab;
  const int c0 = slab * kSlab;
  const int total = a.batch * a.segs, chunks = (a.seq + kChunk - 1) / kChunk;
  const Range range = block_range(kb, total, a.per_slab);
  const int q0 = range.q0, q1 = range.q1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      int st = 0, ph = 0;
      for (int q = q0; q < q1;) {
        const Piece p = piece_at(q, q1, a.segs, chunks);
        for (int j = p.j0; j < p.j1; ++j) {
          hopper::mbar_wait(empty0 + 8 * st, ph ^ 1);
          const uint32_t full = full0 + 8 * st, dst = ring + st * kStageBytes;
          const bool first = j == p.j0 && H > 0;
          hopper::mbar_expect(full, kRowsBytes + (first ? H * kSlab * 2 : 0));
#pragma unroll
          for (int bx = 0; bx < 4; ++bx) {
            if (first)
              hopper::tma_load3(dst + bx * (kHaloRows * 128), &mx_halo, full, c0 + 64 * bx,
                                j * kChunk - H, p.b);
            hopper::tma_load3(dst + kPreBytes + bx * (kChunk * 128), &mx, full, c0 + 64 * bx,
                              j * kChunk, p.b);
          }
          if (++st == a.stages) st = 0, ph ^= 1;
        }
        q += p.n;
      }
    }
    __syncwarp();
    return;
  }

  // the consumers: thread tid owns channels c .. c + V - 1 (in box V tid /
  // 64, at byte (V tid % 64) * 2 of each 128-byte row); warp `warp` owns
  // kWarpCh of them, and their outputs in chunk buffers of its own
  constexpr int kWarpOutBytes = kChunk * kWarpCh * 2;
  const int c = c0 + V * tid;
  const bool active = c < a.d;  // a slab's channels past d: zeros, clipped by the store
  float taps[K][V], bv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      taps[i][v] = active ? __bfloat162float(w[(long long)i * a.d + c + v]) : 0.f;
    bv[v] = active ? __bfloat162float(bias[c + v]) : 0.f;
  }
  const int box = V * tid / 64, in_row = (V * tid % 64) * 2;
  // this thread's word in row 0 of its box of a region of `rows` rows
  auto word = [&](uint32_t region, int rows) {
    return reinterpret_cast<Word*>(smem + (region - ring) + box * rows * 128 + in_row);
  };
  int st = 0, ph = 0;
  int m_run = 0;  // output chunks this block has begun, over its pieces
  // the warp's buffer of output chunk m_abs
  auto out_buffer = [&](int m_abs) {
    return yb + (m_abs % kOutBuffers) * kRowsBytes + warp * kWarpOutBytes;
  };
  // the warp's output chunk m_abs complete in its buffer: the warp stores
  // it, then waits until the store of the chunk before it has read the
  // buffer the next chunk writes (it has had a chunk's walk)
  auto store_y = [&](int m_abs, int b, int row0) {
    hopper::fence_async();
    __syncwarp();
    if (lane == 0) {
      hopper::tma_store3(&my, out_buffer(m_abs), c0 + kWarpCh * warp, row0, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<kOutBuffers - 1>();
    }
    __syncwarp();
  };

  for (int q = q0; q < q1;) {
    const Piece p = piece_at(q, q1, a.segs, chunks);
    float xw[K][V];  // xw[i]: x row t - (K-1) + i
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int v = 0; v < V; ++v) xw[i][v] = 0.f;
    for (int j = p.j0; j < p.j1; ++j) {
      hopper::mbar_wait(full0 + 8 * st, ph);
      const uint32_t stage = ring + st * kStageBytes;
      if (j == p.j0) {
        const Word* pre = word(stage, kHaloRows);
#pragma unroll
        for (int i = 0; i < H; ++i) L::unpack(xw[i + 1], pre[i * kRowWords]);  // the K-1 rows before
      }
      const Word* xs = word(stage + kPreBytes, kChunk);
      const int m_abs = m_run + j - p.j0;
      Word* out = reinterpret_cast<Word*>(smem + (out_buffer(m_abs) - ring)) + lane;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
#pragma unroll
          for (int v = 0; v < V; ++v) xw[i][v] = xw[i + 1][v];
        L::unpack(xw[K - 1], xs[r * kRowWords]);
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < K; ++i) acc = fmaf(xw[i][v], taps[i][v], acc);
          acc += bv[v];
          if (a.silu) acc = acc * (1.f / (1.f + expf(-acc)));
          o[v] = acc;
        }
        out[r * 32] = L::pack(o);  // a row of the warp's box: 32 words
      }
      __syncwarp();  // the warp's reads of the stage are done
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
      if (++st == a.stages) st = 0, ph ^= 1;
      store_y(m_abs, p.b, j * kChunk);
    }
    m_run += p.j1 - p.j0;
    q += p.n;
  }
  if (lane == 0) hopper::bulk_wait_all();
}

template <int K>
int launch_stream(const CUtensorMap (&maps)[3], const bf16* w, const bf16* b,
                  const FwdBf16Args& a, cudaStream_t s) {
  auto* kernel = conv1d_fwd_bf16_kernel<K>;
  static OptIn opted;  // the opt-in above 48 KB, per device
  if (const int err = opt_in_smem(kernel, fwd_smem_bytes(kMaxStages), opted)) return err;
  kernel<<<a.n_slabs * a.per_slab, kThreads, a.smem, s>>>(maps[0], maps[1], maps[2], w, b, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, seq, d) bf16, rows a->x_row_stride values apart (channels
// contiguous); w: (k, d); b: (d,); out: (batch, seq, d) contiguous; all bf16.
// 1 <= k <= kMaxTaps, d and the row stride multiples of 8, x and out 16-byte
// aligned.  The geometry in `a` comes from the wrapper, which memoises it per
// shape; a launch whose geometry does not cover the work is refused.
// Launches on `stream`; returns cudaGetLastError() right after the launch.
extern "C" int conv1d_fused_fwd_bf16_launch(const bf16* x, const bf16* w, const bf16* b,
                                            bf16* out, const FwdBf16Args* a, void* stream) {
  const int segs = (a->seq + kSegRows - 1) / kSegRows;
  const bool ok =
      a->batch >= 1 && a->batch <= 65535 && a->seq >= 1 && a->d >= 1 && a->k >= 1 &&
      a->k <= kMaxTaps && (a->silu == 0 || a->silu == 1) && a->x_row_stride >= a->d &&
      a->d % 8 == 0 && a->x_row_stride % 8 == 0 && aligned16(x) && aligned16(out) &&
      a->n_slabs == (a->d + kSlab - 1) / kSlab &&
      a->segs == segs && a->per_slab >= 1 && a->per_slab <= a->batch * segs &&
      (long long)a->n_slabs * a->per_slab <= 0x7fffffffLL && a->stages >= 2 &&
      a->stages <= kMaxStages && a->smem == fwd_smem_bytes(a->stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  // x and out as (batch, seq, d): x in 64-channel boxes of kChunk rows, and of
  // K-1 rows for the rows before a piece; out in a warp's boxes, kWarpCh
  // channels of kChunk rows
  const int h = a->k > 1 ? a->k - 1 : 1;
  const uint64_t dims[3] = {(uint64_t)a->d, (uint64_t)a->seq, (uint64_t)a->batch};
  const uint64_t xs[2] = {(uint64_t)a->x_row_stride * 2,
                          (uint64_t)a->x_row_stride * 2 * (uint64_t)a->seq};
  const uint64_t ys[2] = {(uint64_t)a->d * 2, (uint64_t)a->d * 2 * (uint64_t)a->seq};
  const uint32_t box[3] = {64, kChunk, 1}, box_h[3] = {64, (uint32_t)h, 1};
  const uint32_t box_y[3] = {kWarpCh, kChunk, 1};
  CUtensorMap maps[3];
  int err = hopper::encode_plain(&maps[0], x, 3, dims, xs, box, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[1], x, 3, dims, xs, box_h, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[2], out, 3, dims, ys, box_y, kPromotion);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a->k) {
    case 1: return launch_stream<1>(maps, w, b, *a, s);
    case 2: return launch_stream<2>(maps, w, b, *a, s);
    case 3: return launch_stream<3>(maps, w, b, *a, s);
    case 4: return launch_stream<4>(maps, w, b, *a, s);
    case 5: return launch_stream<5>(maps, w, b, *a, s);
    case 6: return launch_stream<6>(maps, w, b, *a, s);
    case 7: return launch_stream<7>(maps, w, b, *a, s);
    default: return launch_stream<8>(maps, w, b, *a, s);
  }
}
