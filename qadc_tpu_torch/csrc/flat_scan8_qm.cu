// The query-minor flat 8-bit scan (flat_scan8_qm.cuh): the entry point of
// lut_scan.flat_scan8 from QUERY_MINOR_MIN_QUERIES8 queries on.

#include "flat_scan8_qm.cuh"

// codes (N_pad, m) as row128 storage, tables (Q, m, 256) bf16, out_min and
// out_idx (Q, N_pad / 16). n_blocks: 256-code blocks (N_pad / 256); n: real
// code count; chunk: the queries a block stages (8 to 256 / m).
extern "C" int qadc_flat_scan8_qm(const void* codes, const void* tables, void* out_min,
                                  void* out_idx, int n_blocks, int q_count, int n, int m,
                                  int chunk, void* stream) {
  using namespace qadc;
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 4:
      return launch_flat8_qm_chunk<4, kQmFull>(codes, tables, out_min, out_idx, n_blocks,
                                               q_count, n, chunk, s);
    case 8:
      return launch_flat8_qm_chunk<8, kQmFull>(codes, tables, out_min, out_idx, n_blocks,
                                               q_count, n, chunk, s);
    case 16:
      return launch_flat8_qm_chunk<16, kQmFull>(codes, tables, out_min, out_idx, n_blocks,
                                                q_count, n, chunk, s);
    case 32:
      return launch_flat8_qm_chunk<32, kQmFull>(codes, tables, out_min, out_idx, n_blocks,
                                                q_count, n, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
