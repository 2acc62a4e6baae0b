// The query-minor float32 flat 4-bit scan (flat_scan_qm.cuh): the entry point
// of lut_scan.flat_scan with float tables from QUERY_MINOR_MIN_QUERIES
// queries on.

#include "flat_scan_qm.cuh"

namespace {

template <int CB>
cudaError_t launch_rows(const void* codes, const void* tables, void* out, void* rows_out,
                        int r_count, int q_count, int n, int chunk, cudaStream_t stream) {
  if (rows_out)
    return qadc::launch_flat_qm_chunk<CB, true, qadc::kQmFull>(codes, tables, out, rows_out,
                                                               r_count, q_count, n, chunk, stream);
  return qadc::launch_flat_qm_chunk<CB, false, qadc::kQmFull>(codes, tables, out, nullptr,
                                                              r_count, q_count, n, chunk, stream);
}

}  // namespace

// codes (R, 128), tables (Q, 2*cb, 16) float32, out (Q, R) float32, rows_out
// (Q, R) int32 or null. n: real code count, 0 <= n <= r_count * cpr. chunk:
// the queries a block stages (32, 64, or 128 at cb 8).
extern "C" int qadc_flat_scan_qm(const void* codes, const void* tables, void* out,
                                 void* rows_out, int r_count, int q_count, int n, int cb,
                                 int chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8) return launch_rows<8>(codes, tables, out, rows_out, r_count, q_count, n, chunk, s);
  if (cb == 16) return launch_rows<16>(codes, tables, out, rows_out, r_count, q_count, n, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
