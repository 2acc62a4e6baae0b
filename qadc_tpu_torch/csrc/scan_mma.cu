// Kernels 7 and M1 with int8 tables (Quick ADC), redesigned for Hopper's
// tensor cores: the flat and the grouped 4-bit scan as an int8 product of
// the tables with the codes' one-hot (scan_mma.cuh).
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_tq / lut_scan_reduce at
// window == cpr (flat_scan_mma_kernel) and lut_scan_grouped_tq /
// lut_scan_grouped_prefetch with acc_dtype_name "int32"
// (grouped_scan_mma_kernel), which compute the scan the same way on the
// TPU's matrix unit. The output contracts are those of the lookup kernels
// in flat_scan.cu and grouped_scan.cu, to the letter: per (query or pair,
// storage row) the minimum over the row's real codes of the int32 sum of the
// 2*CB selected table entries, no 127 saturation; 1 << 30 for a row with no
// real code (flat: at or past n; grouped: at or past the partition's size);
// with rows_out (flat only) the code index of the minimum, ties to the
// lower code, -1 for such a row. The float32 instantiations stay on the
// lookup kernels: their sums must keep rows_adc's order bit for bit.
//
// What bounds them on the H100: a one-lookup-per-lane scan is bound by
// shared-memory lookups, 32 a clock an SM (2.05 G lookups at 128 queries x
// 1M codes of 16 sub-quantizers: 0.28 ms at best). As a product the same
// scan is 67 G int8 operations, 34 us at the tensor cores' peak. With
// mma.sync the scan lab (scan_lab.cu) measures the product alone at 0.079 ms,
// the row minima (half-rate integer minima, quarter-rate shuffles) at 0.035
// and the one-hot build (half-rate shifts and byte permutes) at 0.02, and
// the three add up to the whole scan's 0.133 ms: a warp runs in order, and
// placing the minima between the products in program order made the scan
// slower (0.160-0.165 ms). An mma.sync that reads all its operands from
// registers is itself far from the tensor cores' rate; running the two tiles
// of an m-tile back to back, which read the same A registers, took the
// product alone from 0.089 to 0.079 ms. From 48 queries flat_scan therefore
// runs the warpgroup kernel of scan_wgmma.cu (0.069 ms); this kernel serves
// smaller batches, where its time follows the query count, and M1.
//
// Design (scan_mma.cuh): a warp keeps the A fragments of 16*MT table rows in
// registers (flat: MT = 1, 2 or 4 by the batch at CB = 8, so one one-hot
// build feeds up to four mma; 1 or 2 at CB = 16) and walks octs of eight
// storage rows, which it copies into its own shared-memory ring two octs
// ahead (cp.async; the codes stay in L2), building the B fragment in
// registers and storing one 32-byte sector per (query, oct).
// The flat grid is one wave of blocks, so A is loaded once a warp.
//
// grouped_scan_mma_kernel: one block per (group, share of the row octs).
// The block gathers the group's live slots into a list (the table gather by
// slot_pair replaces the lookup kernel's shared-memory staging), and each
// pass takes 16*MT of them as the A rows: the mma count of a pass does not
// depend on how many of its rows are live. A chunk of 1024 slots with no
// live slot does no work; a group of any size runs.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_mma.cuh"

namespace {

using namespace qadc;

constexpr int kSlotChunk = 1024;  // slots gathered at a time

template <int CB, int MT>
__global__ void __launch_bounds__(kMmaThreads, 2)
grouped_scan_mma_kernel(const uint8_t* __restrict__ codes,        // (P, rpp, 128)
                        const int8_t* __restrict__ tables,        // (QA, 2*CB, 16)
                        const int32_t* __restrict__ group_part,   // (gcap,)
                        const int32_t* __restrict__ slot_pair,    // (gcap, G), -1 = empty
                        const int32_t* __restrict__ group_sizes,  // (gcap,) real codes
                        int32_t* __restrict__ out,                // (QA, rpp)
                        int rpp, int group_size) {
  __shared__ int s_pair[kSlotChunk];
  __shared__ int s_live;
  __shared__ CodeRing rings[kMmaWarps];
  const int grp = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int32_t* pairs = slot_pair + static_cast<size_t>(grp) * group_size;
  const uint8_t* part = codes + static_cast<size_t>(group_part[grp]) * rpp * 128;
  const int size = group_sizes[grp];

  for (int first = 0; first < group_size; first += kSlotChunk) {
    if (threadIdx.x == 0) s_live = 0;
    __syncthreads();
    for (int s = first + threadIdx.x; s < min(first + kSlotChunk, group_size); s += kMmaThreads) {
      const int p = pairs[s];
      if (p >= 0) s_pair[atomicAdd(&s_live, 1)] = p;  // any order: a pair owns its out row
    }
    __syncthreads();
    const int live = s_live;
    for (int s0 = 0; s0 < live; s0 += 16 * MT) {
      const int nt = min(MT, (live - s0 + 15) >> 4);
      int idx[MT][2];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = s0 + 16 * j + (lane >> 2) + 8 * h;
          idx[j][h] = s < live ? s_pair[s] : -1;
        }
      uint32_t a[MT][CB][4];
      load_a<CB, MT>(a, nt, tables, idx, lane & 3);
      const int warp = threadIdx.x >> 5;
      scan_rows<CB, MT, kFull, false>(a, nt, part, rpp, size, blockIdx.y * kMmaWarps + warp,
                                      gridDim.y * kMmaWarps, idx, out, nullptr, 0, rings[warp]);
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
}

template <int CB, int MT>
cudaError_t launch_grouped(const void* codes, const void* tables, const void* group_part,
                           const void* slot_pair, const void* group_sizes, void* out, int gcap,
                           int group_size, int rpp, cudaStream_t stream) {
  // One oct a warp: many short blocks balance the groups' uneven sizes (0.055 ms
  // against 0.061 with two octs a warp, 128 queries x 24 probes on an H100).
  // At most 65535 blocks along y.
  const int octs = (rpp + kOct - 1) / kOct;
  int gy = (octs + kMmaWarps - 1) / kMmaWarps;
  gy = gy > 65535 ? 65535 : gy;
  grouped_scan_mma_kernel<CB, MT><<<dim3(gcap, gy), kMmaThreads, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_sizes), static_cast<int32_t*>(out), rpp, group_size);
  return cudaGetLastError();
}

// The fewest m-tiles a warp (1, 2 or at most `most`) that cover q_count queries.
template <int CB, int MOST, bool kRows>
cudaError_t launch_flat(const void* codes, const void* tables, void* out, void* rows_out,
                        int r_count, int q_count, int n, cudaStream_t stream) {
  if (q_count <= 16)
    return launch_flat_mma<CB, 1, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                n, stream);
  if (q_count <= 32 || MOST == 2)
    return launch_flat_mma<CB, 2, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                n, stream);
  return launch_flat_mma<CB, MOST, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                 n, stream);
}

}  // namespace

// int8 tables, int32 out (Q, R); rows_out (Q, R) may be null (minima only).
// n: real code count, 0 <= n <= r_count * cpr.
extern "C" int qadc_flat_scan_mma(const void* codes, const void* tables, void* out,
                                  void* rows_out, int r_count, int q_count, int n, int cb,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && rows_out)
    return launch_flat<8, 4, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 8)
    return launch_flat<8, 4, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  if (cb == 16 && rows_out)
    return launch_flat<16, 2, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 16)
    return launch_flat<16, 2, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 tables, int32 out (QA, rpp).
extern "C" int qadc_grouped_scan_mma(const void* codes, const void* tables,
                                     const void* group_part, const void* slot_pair,
                                     const void* group_sizes, void* out, int gcap,
                                     int group_size, int rpp, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8)
    return launch_grouped<8, 2>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                                group_size, rpp, s);
  if (cb == 16)
    return launch_grouped<16, 1>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                                 group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
