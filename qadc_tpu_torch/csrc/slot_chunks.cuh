// Slot chunks of the grouped scans (grouped_scan.cu, grouped_scan8.cu).
//
// A grouped scan block serves one chunk of a group's G slots (a (query,
// probe) pair each, -1 when empty) and stages the live pairs' tables in
// shared memory. Chunking bounds a block's shared memory by kSmemBudget at
// any group size and table width: a float table of 32 sub-quantizers is
// 2 KB and a bf16 8-bit table of 16 is 8 KB, so G = 128 slots would not fit
// one block. The lookup flat scans (flat_scan.cu, flat_scan8.cu) chunk their
// queries by slot_chunks in the same way; the query-minor ones
// (flat_scan_qm.cuh, flat_scan8_qm.cuh) hold 128 KB of tables a block and take
// their chunk from lut_scan.query_minor_chunk.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qadc {

constexpr int kSmemBudget = 64 * 1024;  // bytes of staged tables per block

struct SlotChunks {
  int chunk;  // slots per chunk
  int count;  // chunks per group (the grid's z extent)
};

// The fewest chunks of at most kSmemBudget / slot_bytes slots, as even as
// they come: every chunk holds at least one slot.
inline SlotChunks slot_chunks(int group_size, int slot_bytes) {
  const int max_chunk = kSmemBudget / slot_bytes;
  const int count = (group_size + max_chunk - 1) / max_chunk;
  return {(group_size + count - 1) / count, count};
}

// Stages chunk blockIdx.z of group blockIdx.x: its pair ids into s_pair and
// the live pairs' tables (table_bytes each, a multiple of 16) into s_tab,
// in slot order. Returns the chunk's slot count, or 0 when none of its
// slots is live (the same value in every thread of the block).
__device__ __forceinline__ int stage_slot_chunk(const int32_t* __restrict__ slot_pair,
                                                const void* __restrict__ tables,
                                                int table_bytes, int group_size, int chunk,
                                                int32_t* s_pair, void* s_tab) {
  const int first = blockIdx.z * chunk;
  const int n = min(chunk, group_size - first);
  const int32_t* pairs = slot_pair + static_cast<size_t>(blockIdx.x) * group_size + first;
  int live = 0;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    s_pair[s] = pairs[s];
    live |= pairs[s] >= 0;
  }
  if (!__syncthreads_or(live)) return 0;
  const int vec = table_bytes / 16;  // 16-byte vectors per table
  for (int i = threadIdx.x; i < n * vec; i += blockDim.x) {
    const int p = s_pair[i / vec];
    if (p >= 0) {
      const auto* src = reinterpret_cast<const uint4*>(
          static_cast<const unsigned char*>(tables) + static_cast<size_t>(p) * table_bytes);
      static_cast<uint4*>(s_tab)[i] = src[i % vec];
    }
  }
  __syncthreads();
  return n;
}

}  // namespace qadc
