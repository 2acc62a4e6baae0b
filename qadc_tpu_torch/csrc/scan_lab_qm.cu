// The scan lab of the query-minor scans (flat_scan_qm.cuh, flat_scan8_qm.cuh):
// each kernel with parts removed, and an empty kernel for the launch floor.
// Instruments, like scan_lab.cu: no search path calls them.
//
// Modes (qadc::QmMode): 1 "copy" (codes in, sentinel out: the byte floor as
// run), 2 "no_min" (lookups and sums, no minimum), 3 "const_code" (lookups at
// a fixed code byte, 0x5A: every group of lanes reads the same entry). Only
// mode 0, the production scan, has a defined output.

#include "flat_scan8_qm.cuh"
#include "flat_scan_qm.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// The float 4-bit scan at 16 sub-quantizers, minima only. codes (R, 128),
// tables (Q, 16, 16) float32, out (Q, R) float32; chunk 32, 64 or 128.
extern "C" int qadc_flat_scan_qm_lab(const void* codes, const void* tables, void* out,
                                     int r_count, int q_count, int n, int chunk, int mode,
                                     void* stream) {
  using namespace qadc;
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch_flat_qm_chunk<8, false, kQmCopy>(codes, tables, out, nullptr, r_count,
                                                     q_count, n, chunk, s);
    case kQmNoMin:
      return launch_flat_qm_chunk<8, false, kQmNoMin>(codes, tables, out, nullptr, r_count,
                                                      q_count, n, chunk, s);
    case kQmConstCode:
      return launch_flat_qm_chunk<8, false, kQmConstCode>(codes, tables, out, nullptr, r_count,
                                                          q_count, n, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The 8-bit scan at 8 sub-quantizers. codes (N_pad, 8) as row128 storage,
// tables (Q, 8, 256) bf16, out_min / out_idx (Q, N_pad / 16); chunk 8, 16 or 32.
extern "C" int qadc_flat_scan8_qm_lab(const void* codes, const void* tables, void* out_min,
                                      void* out_idx, int n_blocks, int q_count, int n, int chunk,
                                      int mode, void* stream) {
  using namespace qadc;
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch_flat8_qm_chunk<8, kQmCopy>(codes, tables, out_min, out_idx, n_blocks,
                                               q_count, n, chunk, s);
    case kQmNoMin:
      return launch_flat8_qm_chunk<8, kQmNoMin>(codes, tables, out_min, out_idx, n_blocks,
                                                q_count, n, chunk, s);
    case kQmConstCode:
      return launch_flat8_qm_chunk<8, kQmConstCode>(codes, tables, out_min, out_idx, n_blocks,
                                                    q_count, n, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One block of one thread that does nothing: the device time of a launch.
extern "C" int qadc_empty_kernel(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
