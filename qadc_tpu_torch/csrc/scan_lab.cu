// The scan lab: the tensor-core scan of scan_mma.cuh with parts removed, and
// a float selector-sum probe. Instruments, like flat_scan_window_regs: no
// search path calls them.
//
// Replaces the JAX package's benchmark-only Pallas kernels, which asked the
// same questions of the TPU scan:
//   benchmarks/ab_tq_ablate.py:scan       full / nocmp / consthot / nomm
//   benchmarks/kernel_lab.py:run_variant  acc_only / expand_only / min_only / copy
//   benchmarks/diag_direct.py:main        is a 0/1 selector product exact in a kernel
// (benchmarks/ab_tq.py:lut_scan_tq, the A/B of two formulations, needs no
// kernel of its own here: it runs the mma kernel against the lookup kernels.)
//
// qadc_scan_lab runs flat_scan_mma_kernel at CB = 8 with a mode, a subset of
// {expand = 1, mma = 2, min = 4}: 7 is the production scan ("full"), 6 a
// constant one-hot ("const_onehot": the mma + minimum floor), 5 no product
// ("no_mma": one-hot build + minimum), 3 no minimum ("no_min"), 1
// "expand_only", 2 "acc_only", 4 "min_only", 0 "copy" (codes in, sentinel
// out: the byte floor as run). Only mode 7's output is the scan's; the
// others write values that depend on what they keep. Mode 7 also runs with
// 1 or 2 m-tiles a warp (16 or 32 queries share a one-hot build, not 64).
//
// selector_sum_kernel answers diag_direct's float question on this card:
// out[r, c] = sum_k x[r, k] * sel[k, c] with sel[k, c] = (k / cb == c), the
// 0/1 selector that compacts a 128-lane row to its cpr code sums, as float32
// multiply-adds in registers. A product with 0 or 1 is exact, so the sum
// holds float32 accuracy (the caller holds it to float64 at 1e-6).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_mma.cuh"

namespace {

using namespace qadc;

__global__ void selector_sum_kernel(const float* __restrict__ x,  // (rows, 128)
                                    float* __restrict__ out,      // (rows, 128 / cb)
                                    int rows, int cb) {
  const int cpr = 128 / cb;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cpr) return;
  const int r = i / cpr;
  const int c = i - r * cpr;
  float acc = 0.0f;
  for (int k = 0; k < 128; ++k)
    acc = fmaf(x[static_cast<size_t>(r) * 128 + k], k / cb == c ? 1.0f : 0.0f, acc);
  out[i] = acc;
}

template <int MODE>
cudaError_t lab(const void* codes, const void* tables, void* out, int r_count, int q_count,
                int n, cudaStream_t stream) {
  return launch_flat_mma<8, 4, MODE, false>(codes, tables, out, nullptr, r_count, q_count, n,
                                            stream);
}

}  // namespace

// codes (R, 128), tables (Q, 16, 16) int8, out (Q, R) int32. mode: the parts
// kept (0..7); mt: m-tiles a warp, 4 for every mode, 1 or 2 for mode 7 only.
extern "C" int qadc_scan_lab(const void* codes, const void* tables, void* out, int r_count,
                             int q_count, int n, int mode, int mt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mt == 1 && mode == kFull)
    return launch_flat_mma<8, 1, kFull, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  if (mt == 2 && mode == kFull)
    return launch_flat_mma<8, 2, kFull, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  if (mt != 4) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return lab<0>(codes, tables, out, r_count, q_count, n, s);
    case 1: return lab<1>(codes, tables, out, r_count, q_count, n, s);
    case 2: return lab<2>(codes, tables, out, r_count, q_count, n, s);
    case 3: return lab<3>(codes, tables, out, r_count, q_count, n, s);
    case 4: return lab<4>(codes, tables, out, r_count, q_count, n, s);
    case 5: return lab<5>(codes, tables, out, r_count, q_count, n, s);
    case 6: return lab<6>(codes, tables, out, r_count, q_count, n, s);
    case 7: return lab<7>(codes, tables, out, r_count, q_count, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (rows, 128) float32 -> out (rows, 128 / cb) float32, cb 8 or 16.
extern "C" int qadc_selector_sum(const void* x, void* out, int rows, int cb, void* stream) {
  if (rows < 1 || (cb != 8 && cb != 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int total = rows * (128 / cb);
  selector_sum_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cb);
  return static_cast<int>(cudaGetLastError());
}
