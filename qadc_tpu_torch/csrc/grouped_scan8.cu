// Kernels 5 + 6: grouped IVF 8-bit conventional-ADC scan to per-window
// minima and the code index of each window's minimum.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan8_grouped_tq (byte-plane
// storage) and its row128 twin lut_scan8_grouped_prefetch. Both share one
// output contract, which this kernel keeps: for every (query, probe) pair and
// every window of its partition, the minimum over the window's codes of
// sum_b T[b][code byte b], the tables in bf16 and the sums in float32 over
// b = 0..M-1, and the argmin, ties to the lowest code. The TPU kernels return
// group-local slot ids; this one returns the partition-local code index.
//
// Windows are the JAX contract at window = min(cpr, 8) (cpr = 128 / M codes
// per 128-byte row): a window is storage row r, in-row positions
// c = c0 + k * cs for k < window, cs = cpr / window. The port numbers window
// (r, c0) as r * cs + c0, so a partition has rpp * cs windows. Codes at or
// past the partition's size never enter a minimum (the port's padded-code
// rule); a window with no real code gets +inf and index -1.
//
// What bounds it on the H100: data-dependent 256-entry lookups in shared
// memory (M per code, with bank conflicts between the lanes of a warp), not
// device-memory bytes: the codes of a partition are read once per chunk of
// pairs, 8 to 32 bytes per code.
//
// Design: one thread block per (group, tile of 128 windows, chunk of slots);
// one thread per window. A chunk's bf16 tables are staged in shared memory as
// [slot][b][256] (M * 512 bytes a pair, so slots are chunked to fit,
// slot_chunks.cuh); each thread holds its window's codes in registers (at most
// 128 bytes) and loops over the chunk's live slots. A chunk with no live slot
// returns at once.
//
// No search path launches this kernel: the slot-minor kernel of
// grouped_scan8_sm.cu replaces it, and it stays as that kernel's A/B arm
// (lut_scan.grouped_scan8_lookup), with the lab modes of qadc_grouped_scan8_lab.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "flat_scan_qm.cuh"  // QmMode (lab modes)
#include "slot_chunks.cuh"

namespace {

using namespace qadc;

constexpr int kThreads = 128;

template <int W>
struct Words;  // one code's W 32-bit words, in one load
template <>
struct Words<1> {
  __device__ static void load(const uint32_t* p, uint32_t* w) { w[0] = p[0]; }
};
template <>
struct Words<2> {
  __device__ static void load(const uint32_t* p, uint32_t* w) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct Words<4> {
  __device__ static void load(const uint32_t* p, uint32_t* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <int M, int MODE>
__global__ void __launch_bounds__(kThreads)
grouped_scan8_kernel(const uint8_t* __restrict__ codes,        // (P, rpp, 128)
                     const uint16_t* __restrict__ tables,      // (QA, M, 256) bf16
                     const int32_t* __restrict__ group_part,   // (gcap,)
                     const int32_t* __restrict__ slot_pair,    // (gcap, G), -1 = empty
                     const int32_t* __restrict__ group_sizes,  // (gcap,) real codes
                     float* __restrict__ out_min,              // (QA, rpp * cs)
                     int32_t* __restrict__ out_idx,            // (QA, rpp * cs)
                     int rpp, int group_size, int chunk, uint32_t keep) {
  constexpr int kCpr = 128 / M;
  constexpr int kWin = kCpr < 8 ? kCpr : 8;
  constexpr int kCs = kCpr / kWin;
  constexpr int kTable = M * 256;  // entries of one pair's table
  constexpr int kWords = M / 4;    // 32-bit words of one code
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem);  // (chunk, M, 256)
  int32_t* s_pair = reinterpret_cast<int32_t*>(smem + static_cast<size_t>(chunk) * kTable * 2);

  const int g = blockIdx.x;
  const int n = qadc::stage_slot_chunk(slot_pair, tables, kTable * 2, group_size, chunk,
                                       s_pair, s_tab);
  if (n == 0) return;  // a chunk of empty slots

  const int windows = rpp * kCs;
  const int win = blockIdx.y * kThreads + threadIdx.x;
  if (win >= windows) return;
  const int row = win / kCs;
  const int c0 = win % kCs;
  const int real = group_sizes[g] - row * kCpr;  // real codes in this row
  if (c0 >= real) {  // the window holds no real code
    for (int s = 0; s < n; ++s) {
      const int p = s_pair[s];
      if (p >= 0) {
        out_min[static_cast<size_t>(p) * windows + win] = INFINITY;
        out_idx[static_cast<size_t>(p) * windows + win] = -1;
      }
    }
    return;
  }

  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      codes + (static_cast<size_t>(group_part[g]) * rpp + row) * 128);
  uint32_t w[kWin * kWords];
#pragma unroll
  for (int k = 0; k < kWin; ++k) Words<kWords>::load(src + (c0 + k * kCs) * kWords, w + k * kWords);
  if (MODE == kQmConstCode) {
#pragma unroll
    for (int k = 0; k < kWin * kWords; ++k) w[k] = (w[k] & keep) | 0x5A5A5A5Au;
  }

  for (int s = 0; s < n; ++s) {
    const int p = s_pair[s];
    if (p < 0) continue;  // uniform across the block
    const uint16_t* t = s_tab + s * kTable;
    float best = MODE == kQmNoMin ? 0.0f : INFINITY;
    int arg = -1;
    if (MODE == kQmCopy) {
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < kWin * kWords; ++k) bits += __popc(w[k]);
      if (bits > 1024u) best = 0.0f;  // never: keeps the loads
    }
#pragma unroll
    for (int k = 0; k < (MODE == kQmCopy ? 0 : kWin); ++k) {
      const int c = c0 + k * kCs;
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < M; ++b) {
        const uint32_t byte = (w[k * kWords + (b >> 2)] >> ((b & 3) * 8)) & 0xFFu;
        acc += bf16_to_float(t[b * 256 + byte]);
      }
      if (MODE == kQmNoMin) {
        best += acc;
      } else if (c < real && acc < best) {  // strict: ties keep the lower code
        best = acc;
        arg = row * kCpr + c;
      }
    }
    out_min[static_cast<size_t>(p) * windows + win] = best;
    out_idx[static_cast<size_t>(p) * windows + win] = arg;
  }
}

template <int M, int MODE = kQmFull>
cudaError_t launch(const void* codes, const void* tables, const void* group_part,
                   const void* slot_pair, const void* group_sizes, void* out_min,
                   void* out_idx, int gcap, int group_size, int rpp, cudaStream_t stream) {
  constexpr int kCpr = 128 / M;
  constexpr int kCs = kCpr < 8 ? 1 : kCpr / 8;
  constexpr int kSlotBytes = M * 256 * 2 + 4;
  const qadc::SlotChunks chunks = qadc::slot_chunks(group_size, kSlotBytes);
  const size_t smem = static_cast<size_t>(chunks.chunk) * kSlotBytes;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_scan8_kernel<M, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(gcap, (rpp * kCs + kThreads - 1) / kThreads, chunks.count);
  grouped_scan8_kernel<M, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint16_t*>(tables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(out_min),
      static_cast<int32_t*>(out_idx), rpp, group_size, chunks.chunk,
      0u);  // lab mode const_code: every code byte 0x5A, the loads kept
  return cudaGetLastError();
}

}  // namespace

extern "C" int qadc_grouped_scan8(const void* codes, const void* tables,
                                  const void* group_part, const void* slot_pair,
                                  const void* group_sizes, void* out_min, void* out_idx,
                                  int gcap, int group_size, int rpp, int m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 4)
    return launch<4>(codes, tables, group_part, slot_pair, group_sizes, out_min, out_idx,
                     gcap, group_size, rpp, s);
  if (m == 8)
    return launch<8>(codes, tables, group_part, slot_pair, group_sizes, out_min, out_idx,
                     gcap, group_size, rpp, s);
  if (m == 16)
    return launch<16>(codes, tables, group_part, slot_pair, group_sizes, out_min, out_idx,
                      gcap, group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scan lab: the kernel at m 8 (8x8 PQ) with parts removed (mode: a
// qadc::QmMode, 1 copy, 2 no_min, 3 const_code). Only copy's output (+inf and
// -1 for every live pair's window) is defined.
extern "C" int qadc_grouped_scan8_lab(const void* codes, const void* tables,
                                      const void* group_part, const void* slot_pair,
                                      const void* group_sizes, void* out_min, void* out_idx,
                                      int gcap, int group_size, int rpp, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch<8, kQmCopy>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                out_idx, gcap, group_size, rpp, s);
    case kQmNoMin:
      return launch<8, kQmNoMin>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                 out_idx, gcap, group_size, rpp, s);
    case kQmConstCode:
      return launch<8, kQmConstCode>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                     out_idx, gcap, group_size, rpp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
