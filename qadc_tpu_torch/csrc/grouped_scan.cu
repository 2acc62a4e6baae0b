// Kernel M1: grouped IVF 4-bit ADC scan to per-row window minima, with int8
// tables (Quick ADC) or float32 tables (conventional 4-bit ADC).
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_grouped_tq (byte-plane
// storage) and its row128 twin lut_scan_grouped_prefetch, with
// acc_dtype_name "int32" and "float32". Both share one output contract,
// which this kernel keeps: for every (query, probe) pair and every window of
// its partition, the minimum over the window's codes of sum_m T[m][nibble_m],
// accumulated in int32 with no 127 saturation (int8 tables) or in float32
// (float tables). At window == codes-per-row (cpr) window i of a partition is
// storage row i, so the kernel reads row128 storage in place and needs no
// slot permutation.
//
// Padded codes: codes at or past the partition's size never enter a minimum
// (the port's padded-code rule), and rows at or past ceil(size / cpr) are
// not read: they get the trim sentinel (1 << 30 for int8 tables, +inf for
// float), which the caller's size mask removes, as the Pallas kernel's
// trimmed blocks do. The per-code sum is adc4_sum.cuh's, in the order of
// rows_adc (rows_adc.cu), so a float window minimum equals the rerank's
// distance of that code bit for bit.
//
// What bounds it on the H100: shared-memory table lookups, not bytes. Each
// code costs 2*CB byte lookups and adds per pair (256 at 16x4 PQ); the codes
// of a partition are read from device memory once per chunk of pairs, so at
// G ~ 12 (IVF-256, ma=24, b=128) the scan does ~24 lookups per code byte read.
//
// Design: one thread block per (group, tile of 128 rows, chunk of slots);
// one thread per storage row. A chunk's tables are staged in shared memory
// as [slot][m][16]: all lanes of a warp look up the same (slot, m) row of 16
// entries, so their loads never conflict. Slots are split into chunks
// (slot_chunks.cuh) so that a block's tables fit its shared memory at any
// group size and table type. Each thread holds its 128-byte row in registers
// (eight 16-byte loads) and loops over the chunk's live slots; for each it
// sums the lookups of each code and keeps the minimum over the row's real
// codes. A chunk with no live slot returns at once.
//
// The float instantiation is no search path's kernel: the slot-minor kernel
// of grouped_scan_sm.cu serves float tables, and this one stays as its A/B
// arm (lut_scan.grouped_scan_f32_lookup), with the lab modes of
// qadc_grouped_scan_lab. The int8 one is lut_scan.grouped_scan_lookup.

#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"
#include "flat_scan_qm.cuh"  // QmMode (lab modes)
#include "slot_chunks.cuh"

namespace {

using qadc::Acc;
using namespace qadc;

constexpr int kRowsPerBlock = 128;

template <int CB, typename T, int MODE>
__global__ void __launch_bounds__(kRowsPerBlock)
grouped_scan_kernel(const uint8_t* __restrict__ codes,       // (P, rpp, 128)
                    const T* __restrict__ tables,            // (QA, 2*CB, 16)
                    const int32_t* __restrict__ group_part,  // (gcap,)
                    const int32_t* __restrict__ slot_pair,   // (gcap, G), -1 = empty
                    const int32_t* __restrict__ group_sizes, // (gcap,) real codes
                    typename Acc<T>::type* __restrict__ out, // (QA, rpp)
                    int rpp, int group_size, int chunk, uint32_t keep) {
  using A = typename Acc<T>::type;
  constexpr int kTable = 2 * CB * 16;  // entries of one pair's table
  constexpr int kTableBytes = kTable * static_cast<int>(sizeof(T));
  constexpr int kCpr = 128 / CB;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);                              // (chunk, 2*CB, 16)
  int32_t* s_pair = reinterpret_cast<int32_t*>(smem + chunk * kTableBytes);

  const int g = blockIdx.x;
  const int n = qadc::stage_slot_chunk(slot_pair, tables, kTableBytes, group_size, chunk,
                                       s_pair, s_tab);
  if (n == 0) return;  // a chunk of empty slots

  const int row = blockIdx.y * kRowsPerBlock + threadIdx.x;
  if (row >= rpp) return;
  const int real = group_sizes[g] - row * kCpr;  // real codes in this row
  if (real <= 0) {
    for (int s = 0; s < n; ++s) {
      const int p = s_pair[s];
      if (p >= 0) out[static_cast<size_t>(p) * rpp + row] = Acc<T>::trim();
    }
    return;
  }

  uint32_t w[32];
  qadc::load_row(codes + (static_cast<size_t>(group_part[g]) * rpp + row) * 128, w);

  if (MODE == kQmConstCode) {
#pragma unroll
    for (int k = 0; k < 32; ++k) w[k] = (w[k] & keep) | 0x5A5A5A5Au;
  }
  for (int s = 0; s < n; ++s) {
    const int p = s_pair[s];
    if (p < 0) continue;  // uniform across the block
    const T* t = s_tab + s * kTable;
    A best = MODE == kQmNoMin ? A(0) : Acc<T>::none();
    if (MODE == kQmCopy) {
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) bits += __popc(w[k]);
      if (bits > 1024u) best = A(0);  // never: keeps the loads
    } else {
#pragma unroll
      for (int c = 0; c < kCpr; ++c) {
        const A acc = qadc::adc4_sum<CB>(w, c, t);
        if (MODE == kQmNoMin) {
          best += acc;
        } else if (c < real && acc < best) {
          best = acc;
        }
      }
    }
    out[static_cast<size_t>(p) * rpp + row] = best;
  }
}

template <int CB, typename T, int MODE = kQmFull>
cudaError_t launch(const void* codes, const void* tables, const void* group_part,
                   const void* slot_pair, const void* group_sizes, void* out, int gcap,
                   int group_size, int rpp, cudaStream_t stream) {
  constexpr int kSlotBytes = 2 * CB * 16 * static_cast<int>(sizeof(T)) + 4;
  const qadc::SlotChunks chunks = qadc::slot_chunks(group_size, kSlotBytes);
  const size_t smem = static_cast<size_t>(chunks.chunk) * kSlotBytes;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_scan_kernel<CB, T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(gcap, (rpp + kRowsPerBlock - 1) / kRowsPerBlock, chunks.count);
  grouped_scan_kernel<CB, T, MODE><<<grid, kRowsPerBlock, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const T*>(tables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_sizes),
      static_cast<typename Acc<T>::type*>(out), rpp, group_size, chunks.chunk,
      0u);  // lab mode const_code: every code byte 0x5A, the loads kept
  return cudaGetLastError();
}

}  // namespace

// f32 == 0: int8 tables, int32 out; f32 != 0: float32 tables, float32 out.
extern "C" int qadc_grouped_scan(const void* codes, const void* tables,
                                 const void* group_part, const void* slot_pair,
                                 const void* group_sizes, void* out, int gcap,
                                 int group_size, int rpp, int cb, int f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && !f32)
    return launch<8, int8_t>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                             group_size, rpp, s);
  if (cb == 16 && !f32)
    return launch<16, int8_t>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                              group_size, rpp, s);
  if (cb == 8 && f32)
    return launch<8, float>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                            group_size, rpp, s);
  if (cb == 16 && f32)
    return launch<16, float>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                             group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scan lab: the float kernel at cb 8 (16x4 PQ) with parts removed (mode:
// a qadc::QmMode, 1 copy, 2 no_min, 3 const_code). Only copy's output (+inf
// for every live pair's row) is defined.
extern "C" int qadc_grouped_scan_lab(const void* codes, const void* tables,
                                     const void* group_part, const void* slot_pair,
                                     const void* group_sizes, void* out, int gcap,
                                     int group_size, int rpp, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch<8, float, kQmCopy>(codes, tables, group_part, slot_pair, group_sizes, out,
                                       gcap, group_size, rpp, s);
    case kQmNoMin:
      return launch<8, float, kQmNoMin>(codes, tables, group_part, slot_pair, group_sizes, out,
                                        gcap, group_size, rpp, s);
    case kQmConstCode:
      return launch<8, float, kQmConstCode>(codes, tables, group_part, slot_pair, group_sizes,
                                            out, gcap, group_size, rpp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
