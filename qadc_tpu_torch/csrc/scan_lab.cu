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
// kernel of its own here: kernels/scan_lab.py:ab_scans runs the int8 scan's
// engines against each other.)
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
// multiply-adds on the CUDA cores (not TF32 mma, which would round x: the TPU
// probe's DEFAULT baseline, not this function). A warp takes a row: lane l
// reads x[r, 4l .. 4l+3] in one 16-byte load (the row's 512 bytes coalesced),
// values that all belong to column c = 4l / cb; it multiplies each by its
// selector entry for c, and a shuffle reduction over the cb / 4 lanes of the
// code finishes the sum (the selector's zeros fall on the other columns'
// lanes). A product with 0 or 1 is exact, so the sum holds float32 accuracy
// (the caller holds it to float64 at 1e-6). Four rows a block: 512 rows fill
// 128 SMs with one round trip each, where the formulation it replaced ran a
// thread an output over a serial chain of 128 loads in 32 blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_mma.cuh"

namespace {

using namespace qadc;

constexpr int kSelectorRows = 4;  // rows (warps) a block

template <int CB>
__global__ void __launch_bounds__(32 * kSelectorRows)
selector_sum_kernel(const float* __restrict__ x,  // (rows, 128)
                    float* __restrict__ out,      // (rows, 128 / CB)
                    int rows) {
  const int r = blockIdx.x * kSelectorRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave: the shuffles below run on full warps
  const int lane = threadIdx.x & 31;
  const float4 v = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * 128) + lane);
  const int k = 4 * lane, c = k / CB;
  float acc = 0.0f;
  acc = fmaf(v.x, (k + 0) / CB == c ? 1.0f : 0.0f, acc);
  acc = fmaf(v.y, (k + 1) / CB == c ? 1.0f : 0.0f, acc);
  acc = fmaf(v.z, (k + 2) / CB == c ? 1.0f : 0.0f, acc);
  acc = fmaf(v.w, (k + 3) / CB == c ? 1.0f : 0.0f, acc);
#pragma unroll
  for (int off = 1; off < CB / 4; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane % (CB / 4) == 0) out[static_cast<size_t>(r) * (128 / CB) + c] = acc;
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
  const unsigned blocks = static_cast<unsigned>((rows + kSelectorRows - 1) / kSelectorRows);
  const auto* xp = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cb == 8)
    selector_sum_kernel<8><<<blocks, 32 * kSelectorRows, 0, s>>>(xp, o, rows);
  else
    selector_sum_kernel<16><<<blocks, 32 * kSelectorRows, 0, s>>>(xp, o, rows);
  return static_cast<int>(cudaGetLastError());
}
