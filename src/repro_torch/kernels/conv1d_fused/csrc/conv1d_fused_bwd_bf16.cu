// The bf16 backward of the depthwise causal conv1d + bias + SiLU, for Hopper
// (sm_90a).
//
// Replaces the reference's gradient of src/repro/core/conv.py:153
// `conv1d_depthwise_causal` + SiLU (XLA's, at bf16: the reference trains
// through no Pallas conv), as `conv1d_fused.cu`'s header states it: for an
// output gradient g,
//     dpre[t] = g[t] * silu'(pre[t])   (g[t] without the SiLU)
//     dx[s]   = sum_i dpre[s + K-1-i] * w[i]
//     dw[i]   = sum_{b,t} dpre[t] * x[t - (K-1) + i],   db = sum_{b,t} dpre[t]
// with x, w, bias and g upcast, pre, silu' and every sum in f32, and dx, dw
// and db rounded to bf16 once.  x is read in place at its row stride (mamba2's
// xBC slice of zxbcdt).
//
// What bounds it on this card: bytes.  x and g read once, dx written once:
// 3 x 2 B an element, 32.0 us at mamba2-1.3b's training shape (B 4, L 1024,
// D 4352) at 3.35 TB/s.  The element's chain (the forward's K FMAs again,
// expf and an IEEE divide for silu', K FMAs for dx, K for dw) is some 40
// instructions: issue is the next limit, at about 70 % of the bytes' time.
//
// What the fp32 template's bf16 instance (the segment-walk kernel, kept below
// for K > 8) lost to, and what this one
// does about it:
//   - A latency-bound walk: each thread loaded x[t] and g[t] and used them at
//     once, one 8-byte row of each in flight.  Here a block streams its rows
//     through a ring of `stages` stages in shared memory: one producer thread
//     issues 3-d TMA boxes (64 channels x 16 rows) of x and g, each stage's
//     completion counted on its `full` mbarrier, its release on `empty`; 3
//     blocks an SM keep up to 120 KB in flight.  Consumers walk the rows from
//     shared memory with the K-row windows in registers, 16 rows unrolled.
//   - dx in 8-byte stores: here dx goes to shared memory and leaves by TMA
//     store (64 x 16 boxes), three chunk buffers deep.
//   - 1.75 waves of blocks: here the grid is 3 blocks an SM, each a channel
//     slab of 256 (256 walking threads, one channel each, and a producer
//     warp: 24 walking warps an SM, which the walk's issue needs) over a
//     contiguous range of the slab's (sequence, 32-row segment) pairs, the
//     ranges even to a segment (5 or 6 at mamba2: 160-192 rows a block).
//   - Partial dw / db rows a 32-row segment (11.1 MB written and read again
//     at mamba2, a fifth of the bound): here a thread sums its channel's
//     rows over the block's whole range, in row order, into one partial row
//     set a block (2.0 MB at mamba2), and the second kernel adds a slab's
//     sets in block order (23 at mamba2 in place of 128 segments): no
//     atomics, the same bits run to run.
// Each element's chain is the segment-walk kernel's (pre by the forward's
// FMAs in tap order, + bias, the same silu' expression, dx's taps in
// order), so dx is bitwise that kernel's; dw and db differ from it by
// their grouping alone (within the same bound against float64).  The first
// K-1 rows of a range come from a (K-1)-row box before it (rows before 0
// read as zero: the causal pad), the K-1 rows after it from one after it.
//
// K 1..8 run this kernel.  A larger K (<= kMaxAnyKBwd) runs the segment-walk kernel,
// kept below unchanged (`conv1d_bwd_any_k_kernel`, windows in local memory,
// and its fixed-order reduction), which the wrapper names.
//
// Tried and measured slower on the card (`conv1d_fused/bwd_choices.py`):
// two channels a walking thread (128 walking threads a block, fewer warps
// to hide the chain's latency), 2 blocks an SM with 3 ring stages in
// place of 3 blocks with 2, and 128-byte L2 promotion of the boxes (no
// different); and the segment-walk kernel's partial row set a 32-row
// segment (9 % slower).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "stream.cuh"
#include "smem_opt_in.cuh"

// one launch's sizes and geometry; `BwdBf16Args` in backward.py mirrors it
struct BwdBf16Args {
  long long x_row_stride;  // values between rows of x (>= d)
  int batch, seq, d, k, silu;
  // K <= 8: the streamed kernel
  int n_slabs;   // channel slabs of kSlab
  int per_slab;  // blocks a slab
  int segs;      // segments of kSegRows rows a sequence
  int stages;    // ring stages
  int smem;      // dynamic shared memory
  // K > 8: the segment-walk kernel
  int vec, threads, n_cblocks, n_strips;
};

namespace {

using hopper::bf16;
using hopper::smem_u32;
using namespace conv1d_stream;  // kSlab, kChunk, kSegRows, kHaloRows, the range split

constexpr int kVec = 1;          // channels a walking thread
constexpr int kConsumers = kSlab / kVec;  // threads that walk
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 4;
// a stage: x's halo rows, x's chunk, g's chunk; each 4 boxes of 64 channels
constexpr int kPreBytes = kHaloRows * kSlab * 2;   // 4096
constexpr int kRowsBytes = kChunk * kSlab * 2;     // 8192
constexpr int kStageBytes = kPreBytes + 2 * kRowsBytes;
constexpr int kDxBuffers = 3;

__host__ __device__ inline int stream_smem_bytes(int stages) {
  return stages * kStageBytes + kDxBuffers * kRowsBytes + 16 * stages + 1024;
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
// a walking thread's kVec channels of one row in shared memory: one word
// (the low half the lower channel), read as f32 and written from f32
using Word = std::conditional<kVec == 2, uint32_t, uint16_t>::type;
constexpr int kRowWords = 128 / sizeof(Word);  // a box row
__device__ __forceinline__ void unpack(float (&v)[kVec], Word w) {
  if constexpr (kVec == 2) {
    v[0] = __uint_as_float((uint32_t)w << 16);
    v[1] = __uint_as_float((uint32_t)w & 0xffff0000u);
  } else {
    v[0] = __uint_as_float((uint32_t)w << 16);
  }
}
__device__ __forceinline__ Word pack_word(const float (&v)[kVec]) {
  if constexpr (kVec == 2) {
    return pack(v[0], v[1]);
  } else {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  }
}

// dw, db: the partial rows summed in order (row 0 first), one thread an
// element, each rounded to bf16 once (the segment-walk kernel's reduction, both paths')
__global__ void __launch_bounds__(128)
conv1d_bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dw,
                         bf16* __restrict__ db, int n_part, int k, int d) {
  const long long n = (long long)(k + 1) * d;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int p = 0; p < n_part; ++p) acc += __ldg(part + p * n + e);
  bf16* out = e < (long long)k * d ? dw + e : db + (e - (long long)k * d);
  *out = __float2bfloat16_rn(acc);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 3)
conv1d_bwd_bf16_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mx_halo,
                       const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap mg_halo,
                       const __grid_constant__ CUtensorMap mdx, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, float* __restrict__ part,
                       const BwdBf16Args a) {
  constexpr int H = K - 1;  // halo rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t dxb = ring + a.stages * kStageBytes;
  const uint32_t full0 = dxb + kDxBuffers * kRowsBytes, empty0 = full0 + 8 * a.stages;

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
      auto next = [&]() {
        if (++st == a.stages) st = 0, ph ^= 1;
      };
      for (int q = q0; q < q1;) {
        const Piece p = piece_at(q, q1, a.segs, chunks);
        for (int j = p.j0; j < p.j1; ++j) {
          hopper::mbar_wait(empty0 + 8 * st, ph ^ 1);
          const uint32_t full = full0 + 8 * st, dst = ring + st * kStageBytes;
          const bool first = j == p.j0 && H > 0;
          hopper::mbar_expect(full, 2 * kRowsBytes + (first ? H * kSlab * 2 : 0));
#pragma unroll
          for (int bx = 0; bx < 4; ++bx) {
            if (first)
              hopper::tma_load3(dst + bx * (kHaloRows * 128), &mx_halo, full, c0 + 64 * bx,
                                j * kChunk - H, p.b);
            hopper::tma_load3(dst + kPreBytes + bx * (kChunk * 128), &mx, full, c0 + 64 * bx,
                              j * kChunk, p.b);
            hopper::tma_load3(dst + kPreBytes + kRowsBytes + bx * (kChunk * 128), &mg, full,
                              c0 + 64 * bx, j * kChunk, p.b);
          }
          next();
        }
        if (H > 0) {  // the K-1 rows after the range (past the sequence: zeros)
          hopper::mbar_wait(empty0 + 8 * st, ph ^ 1);
          const uint32_t full = full0 + 8 * st, dst = ring + st * kStageBytes;
          hopper::mbar_expect(full, 2 * H * kSlab * 2);
#pragma unroll
          for (int bx = 0; bx < 4; ++bx) {
            hopper::tma_load3(dst + bx * (kHaloRows * 128), &mx_halo, full, c0 + 64 * bx,
                              p.j1 * kChunk, p.b);
            hopper::tma_load3(dst + kPreBytes + kRowsBytes + bx * (kChunk * 128), &mg_halo,
                              full, c0 + 64 * bx, p.j1 * kChunk, p.b);
          }
          next();
        }
        q += p.n;
      }
    }
    __syncwarp();
    return;
  }

  // the consumers: thread tid owns channels c .. c + kVec - 1 (in box
  // kVec tid / 64, at byte (kVec tid % 64) * 2 of each 128-byte row)
  const int c = c0 + kVec * tid;
  const bool active = c < a.d;  // a slab's channels past d: zeros throughout
  float taps[K][kVec], bv[kVec], dws[K][kVec], dbs[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      taps[i][v] = active ? __bfloat162float(w[(long long)i * a.d + c + v]) : 0.f;
      dws[i][v] = 0.f;
    }
    bv[v] = active ? __bfloat162float(bias[c + v]) : 0.f;
    dbs[v] = 0.f;
  }
  const int box = kVec * tid / 64, in_row = (kVec * tid % 64) * 2;
  // the thread's dw / db sums as rows of a partial row set at `pc`
  auto write_partial = [&](float* pc) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
#pragma unroll
      for (int i = 0; i < K; ++i) pc[(size_t)i * a.d + v] = dws[i][v];
      pc[(size_t)K * a.d + v] = dbs[v];
    }
  };
  // this thread's word in row 0 of its box of a region of `rows` rows
  auto word = [&](uint32_t region, int rows) {
    return reinterpret_cast<Word*>(smem + (region - ring) + box * rows * 128 + in_row);
  };
  int st = 0, ph = 0;
  int m_run = 0;  // dx chunks this block has begun, over its pieces
  auto next = [&]() {
    if (++st == a.stages) st = 0, ph ^= 1;
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
    next();
  };
  // dx chunk m_abs complete in its buffer: after the store of the chunk
  // before it has read its buffer (it has had a chunk's walk), the block
  // stores it, 4 boxes of 64 channels
  auto store_dx = [&](int m_abs, int b, int row0) {
    hopper::fence_async();
    if (tid == 0) hopper::bulk_wait_read<0>();
    hopper::bar(1, kConsumers);
    if (tid == 0) {
      const uint32_t src = dxb + (m_abs % kDxBuffers) * kRowsBytes;
#pragma unroll
      for (int bx = 0; bx < 4; ++bx)
        hopper::tma_store3(&mdx, src + bx * (kChunk * 128), c0 + 64 * bx, row0, b);
      hopper::bulk_commit();
    }
  };
  // one row of the walk at row t (t < seq: x and g's words, `own`: its
  // dpre sums into dw / db): the windows move on, dpre by the forward's
  // chain, then dx of row t - (K-1) into `out`
  auto step = [&](float (&xw)[K][kVec], float (&dwin)[K][kVec], bool in_seq, bool own, Word xu,
                  Word gu, Word* out) {
#pragma unroll
    for (int i = 0; i < K - 1; ++i)
#pragma unroll
      for (int v = 0; v < kVec; ++v) xw[i][v] = xw[i + 1][v], dwin[i][v] = dwin[i + 1][v];
    float dp[kVec];
    if (in_seq) {
      float gf[kVec];
      unpack(xw[K - 1], xu);
      unpack(gf, gu);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        float pre = 0.f;  // the forward's chain: acc = fmaf(x, w_i, acc), + bias
#pragma unroll
        for (int i = 0; i < K; ++i) pre = fmaf(xw[i][v], taps[i][v], pre);
        pre += bv[v];
        if (a.silu) {
          const float sg = 1.f / (1.f + expf(-pre));
          dp[v] = gf[v] * (sg * (1.f + pre * (1.f - sg)));
        } else {
          dp[v] = gf[v];
        }
        if (own) {
#pragma unroll
          for (int i = 0; i < K; ++i) dws[i][v] = fmaf(dp[v], xw[i][v], dws[i][v]);
          dbs[v] += dp[v];
        }
      }
    } else {  // past the end: no gradient, no input
#pragma unroll
      for (int v = 0; v < kVec; ++v) xw[K - 1][v] = 0.f, dp[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) dwin[K - 1][v] = dp[v];
    if (out != nullptr) {
      float o[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) acc = fmaf(dwin[K - 1 - i][v], taps[i][v], acc);
        o[v] = acc;
      }
      *out = pack_word(o);
    }
  };

  for (int q = q0; q < q1;) {
    const Piece p = piece_at(q, q1, a.segs, chunks);
    // xw[i]: x row t - (K-1) + i; dwin[i]: dpre row t - (K-1) + i
    float xw[K][kVec], dwin[K][kVec];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int v = 0; v < kVec; ++v) xw[i][v] = dwin[i][v] = 0.f;
    for (int j = p.j0; j < p.j1; ++j) {
      hopper::mbar_wait(full0 + 8 * st, ph);
      const uint32_t stage = ring + st * kStageBytes;
      if (j == p.j0) {
        const Word* pre = word(stage, kHaloRows);
#pragma unroll
        for (int i = 0; i < H; ++i) unpack(xw[i + 1], pre[i * kRowWords]);  // the K-1 rows before
      }
      const Word* xs = word(stage + kPreBytes, kChunk);
      const Word* gs = word(stage + kPreBytes + kRowsBytes, kChunk);
      const int m = j - p.j0;  // this piece's chunk
      Word* cur = word(dxb + ((m_run + m) % kDxBuffers) * kRowsBytes, kChunk);
      Word* prev = word(dxb + ((m_run + m + kDxBuffers - 1) % kDxBuffers) * kRowsBytes, kChunk);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        const int t = j * kChunk + r;
        // dx row t - (K-1): in this chunk's buffer from row K-1 of the walk
        // on, in the previous chunk's before (none in a piece's first chunk)
        Word* out = r >= H ? cur + (r - H) * kRowWords
                           : (m > 0 ? prev + (kChunk - H + r) * kRowWords : nullptr);
        step(xw, dwin, t < a.seq, t < a.seq, xs[r * kRowWords], gs[r * kRowWords], out);
      }
      release();
      if (H > 0 && m > 0) store_dx(m_run + m - 1, p.b, (j - 1) * kChunk);
      if (H == 0) store_dx(m_run + m, p.b, j * kChunk);
    }
    if (H > 0) {  // the K-1 rows after the range: dpre for dx only
      hopper::mbar_wait(full0 + 8 * st, ph);
      const uint32_t stage = ring + st * kStageBytes;
      const Word* xs = word(stage, kHaloRows);
      const Word* gs = word(stage + kPreBytes + kRowsBytes, kChunk);
      const int m = p.j1 - 1 - p.j0;
      Word* last = word(dxb + ((m_run + m) % kDxBuffers) * kRowsBytes, kChunk);
#pragma unroll
      for (int r = 0; r < H; ++r) {
        const int t = p.j1 * kChunk + r;
        step(xw, dwin, t < a.seq, false, xs[r * kRowWords], gs[r * kRowWords],
             last + (kChunk - H + r) * kRowWords);
      }
      release();
      store_dx(m_run + m, p.b, (p.j1 - 1) * kChunk);
    }
    m_run += p.j1 - p.j0;
    q += p.n;
  }
  // the block's range done: its partial rows, row set kb of the slab
  if (active) write_partial(part + ((size_t)kb * (K + 1)) * a.d + c);
  if (tid == 0) hopper::bulk_wait_all();
}

// ------------------------------------------ K > 8: the segment-walk kernel

constexpr int kMaxThreadsAnyK = 128;
constexpr int kMaxAnyKBwd = 32;  // taps this kernel takes

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// V values of type T at p, as f32 (read-only path) / f32 stored as T (streaming)
template <typename T, int V>
struct Io;
template <>
struct Io<bf16, 4> {  // one 8-byte access
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[4]) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    const uint32_t w[2] = {(uint32_t)t.x, (uint32_t)t.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
    int w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w[i] = (int)((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
                   ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16));
    __stcs(reinterpret_cast<int2*>(p), make_int2(w[0], w[1]));
  }
};
template <>
struct Io<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* __restrict__ p, float (&v)[1]) {
    v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};

// K = a.k <= kMaxAnyKBwd, windows in local memory; each thread V channels of
// one segment of kSegRows rows (grid: segments, channel blocks, batch)
template <int V>
__global__ void __launch_bounds__(kMaxThreadsAnyK)
conv1d_bwd_any_k_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const bf16* __restrict__ bias, const bf16* __restrict__ g,
                        bf16* __restrict__ dx, float* __restrict__ part, const BwdBf16Args a) {
  using U = Io<bf16, V>;
  constexpr int KW = kMaxAnyKBwd;  // window length
  const int k = a.k;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c >= a.d) return;
  const int s0 = blockIdx.x * kSegRows;
  const int seg_end = min(s0 + kSegRows, a.seq);  // rows whose dpre sums here
  const long long row0 = (long long)blockIdx.z * a.seq;
  const bf16* xc = x + row0 * a.x_row_stride + c;
  const bf16* gc = g + row0 * a.d + c;
  bf16* dxc = dx + row0 * a.d + c;
  float taps[KW][V], b[V], xw[KW][V], dw[KW][V], dwin[KW][V], db[V];
#pragma unroll
  for (int i = 0; i < KW; ++i) {
    if (i < k) U::load(w + (long long)i * a.d + c, taps[i]);
#pragma unroll
    for (int v = 0; v < V; ++v) xw[i][v] = dw[i][v] = dwin[i][v] = 0.f;
  }
  U::load(bias + c, b);
#pragma unroll
  for (int v = 0; v < V; ++v) db[v] = 0.f;
  // xw[j] holds row t - (K-1) + j: before the first row, the K-1 rows
  // before the segment go into xw[1..K-1] (rows before 0 read as zero)
#pragma unroll
  for (int j = 0; j < KW - 1; ++j) {
    const int l = s0 - (k - 1) + j;
    if (j < k - 1 && l >= 0) U::load(xc + l * a.x_row_stride, xw[j + 1]);
  }
  for (int t = s0; t < seg_end + k - 1; ++t) {
#pragma unroll
    for (int j = 0; j < KW - 1; ++j) {
      if (j < k - 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) xw[j][v] = xw[j + 1][v], dwin[j][v] = dwin[j + 1][v];
      }
    }
    float dp[V];
    if (t < a.seq) {
      float gv[V];
      U::load(xc + t * a.x_row_stride, xw[k - 1]);
      U::load(gc + (long long)t * a.d, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float pre = 0.f;  // the forward's chain: acc = fmaf(x, w_i, acc), + bias
#pragma unroll
        for (int i = 0; i < KW; ++i)
          if (i < k) pre = fmaf(xw[i][v], taps[i][v], pre);
        pre += b[v];
        if (a.silu) {
          const float sg = 1.f / (1.f + expf(-pre));
          dp[v] = gv[v] * (sg * (1.f + pre * (1.f - sg)));
        } else {
          dp[v] = gv[v];
        }
      }
      if (t < seg_end) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int i = 0; i < KW; ++i)
            if (i < k) dw[i][v] = fmaf(dp[v], xw[i][v], dw[i][v]);
          db[v] += dp[v];
        }
      }
    } else {  // past the end: no gradient, no input
#pragma unroll
      for (int v = 0; v < V; ++v) xw[k - 1][v] = 0.f, dp[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) dwin[k - 1][v] = dp[v];
    const int s = t - (k - 1);  // dwin[j] holds dpre row s + j
    if (s >= s0) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < KW; ++i)
          if (i < k) acc = fmaf(dwin[k - 1 - i][v], taps[i][v], acc);
        o[v] = acc;
      }
      U::store(dxc + (long long)s * a.d, o);
    }
  }
  // this (sequence, segment)'s partial sums: K rows of dw, then db
  float* pc = part + (long long)(blockIdx.z * a.n_strips + blockIdx.x) * (k + 1) * a.d + c;
#pragma unroll
  for (int i = 0; i < KW; ++i)
    if (i < k) Io<float, V>::store(pc + (long long)i * a.d, dw[i]);
  Io<float, V>::store(pc + (long long)k * a.d, db);
}

// the reduction of `n_part` partial row sets, both paths'
int launch_reduce(const float* part, bf16* dw, bf16* db, int n_part, const BwdBf16Args& a,
                  cudaStream_t s) {
  const long long n = (long long)(a.k + 1) * a.d;
  conv1d_bwd_reduce_kernel<<<(int)((n + 127) / 128), 128, 0, s>>>(part, dw, db, n_part, a.k,
                                                                  a.d);
  return (int)cudaGetLastError();
}

int launch_any_k(const bf16* x, const bf16* w, const bf16* b, const bf16* g, bf16* dx,
                 bf16* dw, bf16* db, float* part, const BwdBf16Args& a, cudaStream_t s) {
  const long long span = (long long)a.threads * a.vec;
  const bool vec_ok = a.vec == 1 || (a.vec == 4 && a.d % 4 == 0 && a.x_row_stride % 4 == 0 &&
                                     aligned16(x) && aligned16(w) && aligned16(b) &&
                                     aligned16(g) && aligned16(dx) && aligned16(part));
  const bool ok = a.k > kMaxTaps && a.k <= kMaxAnyKBwd && vec_ok && a.threads >= 32 &&
                  a.threads <= kMaxThreadsAnyK && a.threads % 32 == 0 &&
                  a.n_strips == (a.seq + kSegRows - 1) / kSegRows && a.n_cblocks >= 1 &&
                  a.n_cblocks <= 65535 && a.n_cblocks * span >= a.d &&
                  (a.n_cblocks - 1) * span < a.d;
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.n_strips, a.n_cblocks, a.batch);
  if (a.vec == 4) {
    conv1d_bwd_any_k_kernel<4><<<grid, a.threads, 0, s>>>(x, w, b, g, dx, part, a);
  } else {
    conv1d_bwd_any_k_kernel<1><<<grid, a.threads, 0, s>>>(x, w, b, g, dx, part, a);
  }
  return launch_reduce(part, dw, db, a.batch * a.n_strips, a, s);
}

// ------------------------------------------------------- K <= 8: launch

template <int K>
int launch_stream(const CUtensorMap (&maps)[5], const bf16* w, const bf16* b, bf16* dw,
                  bf16* db, float* part, const BwdBf16Args& a, cudaStream_t s) {
  auto* kernel = conv1d_bwd_bf16_kernel<K>;
  static OptIn opted;  // the opt-in above 48 KB, per device
  if (const int err = opt_in_smem(kernel, stream_smem_bytes(kMaxStages), opted)) return err;
  kernel<<<a.n_slabs * a.per_slab, kThreads, a.smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                         maps[4], w, b, part, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part, dw, db, a.per_slab, a, s);
}

}  // namespace

// x: (batch, seq, d) rows a->x_row_stride values apart (channels
// contiguous); w: (k, d); b: (d,); g and dx: (batch, seq, d) contiguous; dw
// (k, d), db (d,); all bf16.  `part`: f32 scratch of (k + 1) x d floats a
// partial row set: per_slab sets for K <= 8, batch x segments of kSegRows
// rows for a larger K.  K <= 8 (the streamed kernel): d and
// the row stride multiples of 8, x, g and dx 16-byte aligned.  A launch whose
// geometry does not cover the work is refused.  Two launches on `stream`
// (the kernel, then the reduction of its partial rows); returns the first
// CUDA error (0 on success).
extern "C" int conv1d_fused_bwd_bf16_launch(const bf16* x, const bf16* w, const bf16* b,
                                            const bf16* g, bf16* dx, bf16* dw, bf16* db,
                                            float* part, const BwdBf16Args* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool shape_ok = a->batch >= 1 && a->batch <= 65535 && a->seq >= 1 && a->d >= 1 &&
                        a->k >= 1 && (a->silu == 0 || a->silu == 1) &&
                        a->x_row_stride >= a->d;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  if (a->k > kMaxTaps) return launch_any_k(x, w, b, g, dx, dw, db, part, *a, s);
  const int segs = (a->seq + kSegRows - 1) / kSegRows;
  const bool ok = a->d % 8 == 0 && a->x_row_stride % 8 == 0 && aligned16(x) && aligned16(g) &&
                  aligned16(dx) && aligned16(part) &&
                  a->n_slabs == (a->d + kSlab - 1) / kSlab && a->segs == segs &&
                  a->per_slab >= 1 && a->per_slab <= a->batch * segs && a->stages >= 2 &&
                  a->stages <= kMaxStages && a->smem == stream_smem_bytes(a->stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  // x, g and dx as (batch, seq, d): 64-channel boxes of kChunk rows, and of
  // K-1 rows for the rows around a range
  const int h = a->k > 1 ? a->k - 1 : 1;
  const uint64_t dims[3] = {(uint64_t)a->d, (uint64_t)a->seq, (uint64_t)a->batch};
  const uint64_t xs[2] = {(uint64_t)a->x_row_stride * 2,
                          (uint64_t)a->x_row_stride * 2 * (uint64_t)a->seq};
  const uint64_t gs[2] = {(uint64_t)a->d * 2, (uint64_t)a->d * 2 * (uint64_t)a->seq};
  const uint32_t box[3] = {64, kChunk, 1}, box_h[3] = {64, (uint32_t)h, 1};
  CUtensorMap maps[5];
  int err = hopper::encode_plain(&maps[0], x, 3, dims, xs, box, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[1], x, 3, dims, xs, box_h, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[2], g, 3, dims, gs, box, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[3], g, 3, dims, gs, box_h, kPromotion);
  if (!err) err = hopper::encode_plain(&maps[4], dx, 3, dims, gs, box, kPromotion);
  if (err) return err;
  switch (a->k) {
    case 1: return launch_stream<1>(maps, w, b, dw, db, part, *a, s);
    case 2: return launch_stream<2>(maps, w, b, dw, db, part, *a, s);
    case 3: return launch_stream<3>(maps, w, b, dw, db, part, *a, s);
    case 4: return launch_stream<4>(maps, w, b, dw, db, part, *a, s);
    case 5: return launch_stream<5>(maps, w, b, dw, db, part, *a, s);
    case 6: return launch_stream<6>(maps, w, b, dw, db, part, *a, s);
    case 7: return launch_stream<7>(maps, w, b, dw, db, part, *a, s);
    default: return launch_stream<8>(maps, w, b, dw, db, part, *a, s);
  }
}
