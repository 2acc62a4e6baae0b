// Query chunks of the lookup flat scans (flat_scan.cu, flat_scan8.cu,
// flat_scan_window.cu).
//
// A block of a lookup flat scan stages one chunk of the queries' tables in
// shared memory. Chunking bounds a block's shared memory by kSmemBudget at
// any batch and table width: a float table of 32 sub-quantizers is 2 KB and
// a bf16 8-bit table of 16 is 8 KB, so 128 queries would not fit one block.
// The query-minor scans (flat_scan_qm.cuh, flat_scan8_qm.cuh) hold 128 KB of
// tables a block and take their chunk from lut_scan.query_minor_chunk.

#pragma once

namespace qadc {

constexpr int kSmemBudget = 64 * 1024;  // bytes of staged tables per block

struct SlotChunks {
  int chunk;  // queries per chunk
  int count;  // chunks (the grid's y extent)
};

// The fewest chunks of at most kSmemBudget / query_bytes queries, as even as
// they come: every chunk holds at least one query.
inline SlotChunks slot_chunks(int queries, int query_bytes) {
  const int max_chunk = kSmemBudget / query_bytes;
  const int count = (queries + max_chunk - 1) / max_chunk;
  return {(queries + count - 1) / count, count};
}

}  // namespace qadc
