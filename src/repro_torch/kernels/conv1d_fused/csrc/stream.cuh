// What the bf16 conv1d streams share (`conv1d_fused_fwd_bf16.cu`, the
// forward, and `conv1d_fused_bwd_bf16.cu`, the backward): the channel slab,
// the chunk a ring stage holds, the segment a block's range counts in, and
// the split of a slab's flattened (sequence, segment) pairs into one
// contiguous range a block.  The copies themselves are `hopper.cuh`'s stream
// section (`tma_load3`, `tma_store3`, `encode_plain`).
//
// A slab is kSlab channels: 4 TMA boxes of 64 channels (128 bytes a row).  A
// block walks its range a piece at a time (`piece_at`): the run of segments
// that lie in one sequence, as chunks of kChunk rows.  The K-1 rows before a
// piece come in a box of their own (at most kHaloRows rows), whose rows
// before 0 the copy fills with zeros: the causal pad.

#pragma once

#include "../../flash_attention/csrc/hopper.cuh"

namespace conv1d_stream {

constexpr int kMaxTaps = 8;      // K up to this streams
constexpr int kSlab = 256;       // channels a block
constexpr int kChunk = 16;       // rows a chunk
constexpr int kSegRows = 32;     // rows of a segment, the unit of a block's range
constexpr int kHaloRows = 8;     // room for the K-1 rows before / after a range
static_assert(kSegRows == 2 * kChunk, "a segment is two chunks");
static_assert(kMaxTaps - 1 <= kHaloRows, "the halo box fits its room");
// a row of a slab is 4 boxes of 128 bytes, all in one stage: L2 lines of 256
constexpr CUtensorMapL2promotion kPromotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;

// the flattened (sequence, segment) pairs [q0, q1) of block kb of a slab's
// per_slab blocks, out of `total`: ranges even to a segment
struct Range {
  int q0, q1;
};
__device__ __forceinline__ Range block_range(int kb, int total, int per_slab) {
  return Range{(int)((long long)kb * total / per_slab),
               (int)((long long)(kb + 1) * total / per_slab)};
}

// the piece of a block's segment range that starts at flattened segment q:
// sequence b, its segments [s0, s0 + n), chunks [j0, j1)
struct Piece {
  int b, s0, n, j0, j1;
};
__device__ __forceinline__ Piece piece_at(int q, int q1, int segs, int chunks) {
  const int b = q / segs, s0 = q - b * segs, s1 = min(segs, s0 + (q1 - q));
  return Piece{b, s0, s1 - s0, 2 * s0, min(2 * s1, chunks)};
}

}  // namespace conv1d_stream
