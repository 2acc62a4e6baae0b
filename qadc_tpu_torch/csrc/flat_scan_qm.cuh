// Kernels 7 + 8 with float32 tables, query-minor: the flat 4-bit ADC scan to
// per-query row minima (conventional 4-bit ADC), and optionally the code
// index of each minimum. The same contract, bit for bit, as flat_scan.cu's
// kernel, which it replaces from lut_scan.QUERY_MINOR_MIN_QUERIES queries on.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_tq and lut_scan_reduce at
// window = cpr with acc_dtype_name="float32" (see flat_scan.cu for the
// contract: minima over a storage row's real codes, ties to the lower code,
// +inf and -1 for a row with no real code, sums in adc4_sum.cuh's order).
//
// What bounds it on the H100: shared-memory bandwidth. A float lookup fetches
// four bytes, an SM's shared memory delivers 128 bytes a clock, so 132 SMs
// look up at most 32 x 132 entries a clock whatever the kernel. The row-a-
// thread kernel stayed at half of that: a 1 KB float table a query let a
// block stage 64 queries (three blocks, twelve warps an SM), and every lookup
// cost its lane a byte extract, a nibble extract and an address.
//
// Design: a lane is QPL queries, a code is warp-uniform.
//   - The tables of a chunk of 32 * QPL queries (QPL = 1, 2 or 4: 32, 64 or
//     128 queries) lie in shared memory query-minor, [m][16][query]: the
//     staging loop transposes them from their global (Q, M, 16) layout. At
//     16 sub-quantizers 128 queries take 128 KB, so one persistent block of
//     16 warps an SM stages once and the codes pass once.
//   - A warp takes a storage row (eight 16-byte loads, every lane the same
//     address) and walks its codes; a lookup is one vector load of the lane's
//     QPL queries at (m * 16 + nibble) * chunk + lane * QPL, so the warp reads
//     consecutive bytes whatever the code byte: no bank conflict, and the
//     byte, nibble and address are computed once for QPL lookups.
//   - A lane keeps its queries' running minima over the row's codes with a
//     strict <: no shuffles.
//   - out[q, row] with q across lanes would be strided by r_count, so a tile
//     of 32 rows is staged in shared memory (two buffers: one barrier a tile)
//     and written row-contiguous, 128 bytes a query.
// MODE removes parts for the scan lab (kernels/scan_lab.py).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"

namespace qadc {

constexpr int kQmThreads = 512;
constexpr int kQmWarps = kQmThreads / 32;
constexpr int kQmRowsPerWarp = 2;
constexpr int kQmTileRows = kQmWarps * kQmRowsPerWarp;  // 32 rows: 128 bytes a query
constexpr int kQmStride = kQmTileRows + 1;              // staging row, padded

// Lab modes: the whole scan; codes in, sentinel out; lookups and sums with no
// minimum; lookups at a fixed code byte.
enum QmMode { kQmFull = 0, kQmCopy = 1, kQmNoMin = 2, kQmConstCode = 3 };

template <int CB, int QPL>
struct FlatQm {
  static constexpr int kChunk = 32 * QPL;
  static constexpr int kEntries = 2 * CB * 16;
  static constexpr uint32_t kTabBytes = kEntries * kChunk * 4u;
  static constexpr uint32_t kAlign = 16u * kChunk * 4u;  // one sub-quantizer's entries
  static constexpr uint32_t kStageBytes = 2u * kChunk * kQmStride * 4u;
  static constexpr size_t smem(bool with_rows) {
    return kAlign + kTabBytes + kStageBytes * (with_rows ? 2 : 1);
  }
};

// Transposes the (Q, 2*CB, 16) float32 tables of queries q0 .. q0 + nq - 1
// into s_tab as [2*CB][16][32 * QPL], zeros past nq. A warp stores 32
// queries at one vector: no bank conflict.
template <int CB, int QPL>
__device__ __forceinline__ void stage_query_minor(const float* __restrict__ tables, int q0,
                                                  int nq, float* s_tab) {
  constexpr int kChunk = FlatQm<CB, QPL>::kChunk;
  constexpr int kVecs = FlatQm<CB, QPL>::kEntries / 4;  // 16-byte vectors of one query's table
  const float4* src = reinterpret_cast<const float4*>(tables) + static_cast<size_t>(q0) * kVecs;
  for (int i = threadIdx.x; i < kChunk * kVecs; i += blockDim.x) {
    const int q = i % kChunk;
    const int vec = i / kChunk;
    const float4 v = q < nq ? src[static_cast<size_t>(q) * kVecs + vec]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float* dst = s_tab + (vec * 4) * kChunk + q;
    dst[0] = v.x;
    dst[kChunk] = v.y;
    dst[2 * kChunk] = v.z;
    dst[3 * kChunk] = v.w;
  }
}

template <int CB, int QPL, bool kWithRows, int MODE>
__global__ void __launch_bounds__(kQmThreads, 1)
flat_scan_qm_kernel(const uint8_t* __restrict__ codes,   // (R, 128)
                    const float* __restrict__ tables,    // (Q, 2*CB, 16)
                    float* __restrict__ out,             // (Q, R)
                    int32_t* __restrict__ rows_out,      // (Q, R), kWithRows only
                    int r_count, int q_count, int n, uint32_t keep, uint32_t fixed) {
  using G = FlatQm<CB, QPL>;
  constexpr int kChunk = G::kChunk;
  constexpr int kCpr = 128 / CB;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t tab = (base + G::kAlign - 1) & ~(G::kAlign - 1);
  float* s_tab = reinterpret_cast<float*>(smem + (tab - base));   // [2*CB*16][chunk]
  float* s_out = s_tab + G::kEntries * kChunk;                    // [2][chunk][kQmStride]
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_out + 2 * kChunk * kQmStride);

  const int q0 = blockIdx.y * kChunk;
  const int nq = min(kChunk, q_count - q0);
  stage_query_minor<CB, QPL>(tables, q0, nq, s_tab);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane_addr = tab + lane * QPL * 4;
  const int tiles = (r_count + kQmTileRows - 1) / kQmTileRows;
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int row0 = tile * kQmTileRows + warp * kQmRowsPerWarp;
    uint32_t w[kQmRowsPerWarp][32];
#pragma unroll
    for (int r = 0; r < kQmRowsPerWarp; ++r)
      if (row0 + r < r_count && n - (row0 + r) * kCpr > 0)
        load_row(codes + static_cast<size_t>(row0 + r) * 128, w[r]);
#pragma unroll
    for (int r = 0; r < kQmRowsPerWarp; ++r) {
      const int row = row0 + r;
      const int real = row < r_count ? n - row * kCpr : 0;  // real codes in this row
      float best[QPL];
      int arg[QPL];
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        best[i] = MODE == kQmNoMin ? 0.0f : INFINITY;
        arg[i] = 0;
      }
      if (real > 0) {
        if (MODE == kQmCopy) {
          uint32_t bits = 0;
#pragma unroll
          for (int k = 0; k < 32; ++k) bits += __popc(w[r][k]);
          if (bits > 1024u) best[0] = 0.0f;  // never: keeps the loads
        } else {
          if (MODE == kQmConstCode) {
#pragma unroll
            for (int k = 0; k < 32; ++k) w[r][k] = (w[r][k] & keep) | fixed;
          }
#pragma unroll
          for (int c = 0; c < kCpr; ++c) {
            float acc[QPL];
            adc4_sum_query_minor<CB, QPL>(w[r], c, lane_addr, acc);
#pragma unroll
            for (int i = 0; i < QPL; ++i) {
              if (MODE == kQmNoMin) {
                best[i] += acc[i];
              } else if (c < real && acc[i] < best[i]) {  // strict: ties keep the lower code
                best[i] = acc[i];
                arg[i] = c;
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int o = (buf * kChunk + lane * QPL + i) * kQmStride + warp * kQmRowsPerWarp + r;
        s_out[o] = best[i];
        if (kWithRows) s_idx[o] = real > 0 ? row * kCpr + arg[i] : -1;
      }
    }
    __syncthreads();
    // The tile's minima, a query's 32 rows contiguous. The next tile fills
    // the other buffer, and its barrier comes after every thread has left
    // this loop.
    const int first = tile * kQmTileRows;
    const int rows_here = min(kQmTileRows, r_count - first);
    for (int e = threadIdx.x; e < nq * kQmTileRows; e += kQmThreads) {
      const int q = e / kQmTileRows;
      const int col = e % kQmTileRows;
      if (col < rows_here) {
        const size_t o = static_cast<size_t>(q0 + q) * r_count + first + col;
        out[o] = s_out[(buf * kChunk + q) * kQmStride + col];
        if (kWithRows) rows_out[o] = s_idx[(buf * kChunk + q) * kQmStride + col];
      }
    }
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return 1;
  return sms;
}

template <int CB, int QPL, bool kWithRows, int MODE>
cudaError_t launch_flat_qm(const void* codes, const void* tables, void* out, void* rows_out,
                           int r_count, int q_count, int n, cudaStream_t stream) {
  using G = FlatQm<CB, QPL>;
  const size_t smem = G::smem(kWithRows);
  auto kernel = flat_scan_qm_kernel<CB, QPL, kWithRows, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (r_count + kQmTileRows - 1) / kQmTileRows;
  const int sms = sm_count();
  const dim3 grid(tiles < sms ? tiles : sms, (q_count + G::kChunk - 1) / G::kChunk);
  // Lab mode const_code: every code byte 0x5A.
  kernel<<<grid, kQmThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(tables),
      static_cast<float*>(out), static_cast<int32_t*>(rows_out), r_count, q_count, n, 0u,
      0x5A5A5A5Au);
  return cudaGetLastError();
}

// chunk: queries a block stages, 32, 64 or 128 (lut_scan.query_minor_chunk);
// 128 needs 16 sub-quantizers.
template <int CB, bool kWithRows, int MODE>
cudaError_t launch_flat_qm_chunk(const void* codes, const void* tables, void* out,
                                 void* rows_out, int r_count, int q_count, int n, int chunk,
                                 cudaStream_t stream) {
  if (chunk == 32)
    return launch_flat_qm<CB, 1, kWithRows, MODE>(codes, tables, out, rows_out, r_count, q_count,
                                                  n, stream);
  if (chunk == 64)
    return launch_flat_qm<CB, 2, kWithRows, MODE>(codes, tables, out, rows_out, r_count, q_count,
                                                  n, stream);
  if constexpr (CB == 8) {
    if (chunk == 128)
      return launch_flat_qm<CB, 4, kWithRows, MODE>(codes, tables, out, rows_out, r_count,
                                                    q_count, n, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace qadc
