// Kernel M1: grouped IVF 4-bit Quick-ADC scan to per-row window minima.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_grouped_tq (byte-plane
// storage) and its row128 twin lut_scan_grouped_prefetch. Both share one
// output contract, which this kernel keeps: for every (query, probe) pair
// and every window of its partition, the minimum over the window's codes of
// sum_m T[m][nibble_m], accumulated in int32 with no 127 saturation. At
// window == codes-per-row (cpr) window i of a partition is storage row i, so
// the kernel reads row128 storage in place and needs no slot permutation.
//
// What bounds it on the H100: shared-memory table lookups, not bytes. Each
// code costs 2*CB byte lookups and adds per pair (256 at 16x4 PQ); the codes
// of a partition are read from device memory once per group of up to G
// pairs, so at G ~ 12 (IVF-256, ma=24, b=128) the scan does ~24 lookups
// per code byte read.
//
// Design: one thread block per (group, tile of 128 rows); one thread per
// storage row. The group's int8 tables are staged in shared memory as
// [slot][m][16]: all lanes of a warp look up the same (slot, m) row of 16
// bytes, so their loads hit at most four banks and never conflict. Each
// thread holds its 128-byte row in registers (eight 16-byte loads) and loops
// over the group's live slots; for each it sums the lookups of each code and
// keeps the minimum over the row. Rows at or past ceil(size / cpr) are not
// read: they get the trim sentinel 1 << 30, which the caller's size mask
// removes, as the Pallas kernel's trimmed blocks do.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kTrimSentinel = 1 << 30;

template <int CB>
__global__ void __launch_bounds__(kRowsPerBlock)
grouped_scan_kernel(const uint8_t* __restrict__ codes,      // (P, rpp, 128)
                    const int8_t* __restrict__ qtables,     // (QA, 2*CB, 16)
                    const int32_t* __restrict__ group_part, // (gcap,)
                    const int32_t* __restrict__ slot_pair,  // (gcap, G), -1 = empty
                    const int32_t* __restrict__ group_rows, // (gcap,)
                    int32_t* __restrict__ out,              // (QA, rpp)
                    int rpp, int group_size) {
  constexpr int kTable = 2 * CB * 16;  // bytes of one pair's table
  constexpr int kCpr = 128 / CB;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_tab = reinterpret_cast<int8_t*>(smem);                 // (G, 2*CB, 16)
  int32_t* s_pair = reinterpret_cast<int32_t*>(smem + group_size * kTable);

  const int g = blockIdx.x;
  const int32_t* pairs = slot_pair + static_cast<size_t>(g) * group_size;
  for (int s = threadIdx.x; s < group_size; s += blockDim.x) s_pair[s] = pairs[s];
  constexpr int kVec = kTable / 16;  // 16-byte vectors per table
  for (int i = threadIdx.x; i < group_size * kVec; i += blockDim.x) {
    const int p = pairs[i / kVec];
    if (p >= 0) {
      reinterpret_cast<uint4*>(s_tab)[i] =
          reinterpret_cast<const uint4*>(qtables + static_cast<size_t>(p) * kTable)[i % kVec];
    }
  }
  __syncthreads();

  const int row = blockIdx.y * kRowsPerBlock + threadIdx.x;
  if (row >= rpp) return;
  if (row >= group_rows[g]) {
    for (int s = 0; s < group_size; ++s) {
      const int p = s_pair[s];
      if (p >= 0) out[static_cast<size_t>(p) * rpp + row] = kTrimSentinel;
    }
    return;
  }

  const uint4* src = reinterpret_cast<const uint4*>(
      codes + (static_cast<size_t>(group_part[g]) * rpp + row) * 128);
  uint32_t w[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 v = src[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }

  for (int s = 0; s < group_size; ++s) {
    const int p = s_pair[s];
    if (p < 0) continue;  // uniform across the block
    const int8_t* t = s_tab + s * kTable;
    int best = INT_MAX;
#pragma unroll
    for (int c = 0; c < kCpr; ++c) {
      int acc = 0;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int byte_idx = c * CB + b;
        const uint32_t byte = (w[byte_idx >> 2] >> ((byte_idx & 3) * 8)) & 0xFFu;
        acc += t[(2 * b) * 16 + (byte & 15u)];      // even sub-quantizer: low nibble
        acc += t[(2 * b + 1) * 16 + (byte >> 4)];   // odd sub-quantizer: high nibble
      }
      best = min(best, acc);
    }
    out[static_cast<size_t>(p) * rpp + row] = best;
  }
}

template <int CB>
cudaError_t launch(const void* codes, const void* qtables, const void* group_part,
                   const void* slot_pair, const void* group_rows, void* out,
                   int gcap, int group_size, int rpp, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(group_size) * (2 * CB * 16 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_scan_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(gcap, (rpp + kRowsPerBlock - 1) / kRowsPerBlock);
  grouped_scan_kernel<CB><<<grid, kRowsPerBlock, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(qtables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_rows), static_cast<int32_t*>(out), rpp,
      group_size);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qadc_grouped_scan(const void* codes, const void* qtables,
                                 const void* group_part, const void* slot_pair,
                                 const void* group_rows, void* out, int gcap,
                                 int group_size, int rpp, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cb == 8)
    return launch<8>(codes, qtables, group_part, slot_pair, group_rows, out, gcap,
                     group_size, rpp, s);
  if (cb == 16)
    return launch<16>(codes, qtables, group_part, slot_pair, group_rows, out, gcap,
                      group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
