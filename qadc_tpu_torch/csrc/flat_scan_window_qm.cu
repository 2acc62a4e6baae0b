// Kernel 8 with float32 tables, query-minor: the flat 4-bit ADC scan to
// window minima at any (block_n, window), with the argmin's code id on
// request. The same contract, bit for bit, as flat_scan_window.cu's
// flat_scan_window_kernel, which it replaces from
// lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES queries on; below, and at any
// batch as lut_scan.flat_scan_window_f32_lookup, that kernel runs.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_reduce with
// acc_dtype_name="float32" (see flat_scan_window.cu for the contract: the
// JAX slot membership, window g of a block = slots {g, g + G, ...}; ties to
// the lowest slot; padded codes enter no minimum; +inf and -1 for a window
// with no real code; sums in adc4_sum.cuh's order, so every minimum is bit
// for bit the rerank's distance of one of its codes, which rules out the
// tensor cores).
//
// What bounds it on the H100: shared-memory bandwidth, as flat_scan_qm.cuh.
// Every (query, code) pair costs 2*CB float lookups of 4 bytes, and an SM's
// shared memory delivers 128 bytes a clock.
//
// Design: flat_scan_qm.cuh's shape, walking windows instead of storage rows.
//   - A block stages the tables of a chunk of 32 * QPL queries query-minor,
//     [m][16][query] (stage_query_minor), once: one persistent block an SM.
//   - A warp takes a window and walks its W slots in rank order; the code of
//     a slot is warp-uniform, read from device memory (every lane the same
//     address), the next rank's code loaded before this one is summed. A
//     lookup is one conflict-free vector load of the lane's QPL entries.
//   - A lane keeps its queries' minima with a strict < and the rank of the
//     minimum: the lowest tied rank is the lowest tied slot.
//   - The natural (C, Q) output, queries across lanes, is written coalesced
//     straight from the lanes, and so are the ids (C, Q). The transposed
//     (Q, C) minima go through a staged tile of 32 windows, two buffers, one
//     barrier a tile, as flat_scan_qm.cuh writes its rows.
// A window's slots need no shared memory, so any block_n fits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"
#include "flat_scan_qm.cuh"
#include "window_columns.cuh"

namespace {

using qadc::FastDiv;
using qadc::FlatQm;
using qadc::kQmRowsPerWarp;
using qadc::kQmStride;
using qadc::kQmThreads;
using qadc::kQmTileRows;

// The CB / 4 words of code `code` (warp-uniform: one address for the warp).
template <int CB>
__device__ __forceinline__ void load_code(const uint8_t* __restrict__ codes, int code,
                                          uint32_t (&cw)[CB / 4]) {
  if constexpr (CB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes) + code);
    cw[0] = v.x;
    cw[1] = v.y;
    cw[2] = v.z;
    cw[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(codes) + code);
    cw[0] = v.x;
    cw[1] = v.y;
  }
}

// Where a window's slots lie: slot s = c*R + r of block blk is code
// blk*block_n + r*cpr + c.
struct WindowSlots {
  FastDiv groups;  // G = block_n / W
  FastDiv rows;    // R = block_n / cpr
  int block_n, window;
};

template <int CB>
__device__ __forceinline__ int slot_code(const WindowSlots& ws, int base, uint32_t slot) {
  const uint32_t c = ws.rows.div(slot);
  return base + static_cast<int>((slot - c * ws.rows.d) * (128 / CB) + c);
}

template <int CB, int QPL, bool kWithRows, bool kTransposed>
__global__ void __launch_bounds__(kQmThreads, 1)
flat_scan_window_qm_kernel(const uint8_t* __restrict__ codes,   // (N_pad / cpr, 128)
                           const float* __restrict__ tables,    // (Q, 2*CB, 16)
                           float* __restrict__ out,             // (C, Q) or (Q, C)
                           int32_t* __restrict__ rows_out,      // (C, Q), kWithRows only
                           int c_total, int q_count, int n, WindowSlots ws) {
  using G = FlatQm<CB, QPL>;
  constexpr int kChunk = G::kChunk;
  constexpr int kShift = qadc::kQueryMinorShift<QPL>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t tab = (base_addr + G::kAlign - 1) & ~(G::kAlign - 1);
  float* s_tab = reinterpret_cast<float*>(smem + (tab - base_addr));  // [2*CB*16][chunk]
  float* s_out = s_tab + G::kEntries * kChunk;                        // [2][chunk][kQmStride]

  const int q0 = blockIdx.y * kChunk;
  const int nq = min(kChunk, q_count - q0);
  qadc::stage_query_minor<CB, QPL>(tables, q0, nq, s_tab);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane_addr = tab + lane * QPL * 4;
  const int tiles = (c_total + kQmTileRows - 1) / kQmTileRows;
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
#pragma unroll 1
    for (int r = 0; r < kQmRowsPerWarp; ++r) {
      const int col = warp * kQmRowsPerWarp + r;
      const int win = tile * kQmTileRows + col;
      float best[QPL];
      int arg[QPL];  // rank of the minimum, -1 while none
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        best[i] = INFINITY;
        arg[i] = -1;
      }
      int blk_base = 0;
      uint32_t g = 0;
      if (win < c_total) {
        const uint32_t blk = ws.groups.div(static_cast<uint32_t>(win));
        g = static_cast<uint32_t>(win) - blk * ws.groups.d;
        blk_base = static_cast<int>(blk) * ws.block_n;
        uint32_t cw[CB / 4];
        int code = slot_code<CB>(ws, blk_base, g);
        load_code<CB>(codes, code, cw);
        for (int k = 0; k < ws.window; ++k) {
          uint32_t cur[CB / 4];
#pragma unroll
          for (int v = 0; v < CB / 4; ++v) cur[v] = cw[v];
          const int cur_code = code;
          if (k + 1 < ws.window) {  // the next rank's code, in flight during this sum
            code = slot_code<CB>(ws, blk_base, g + (k + 1) * ws.groups.d);
            load_code<CB>(codes, code, cw);
          }
          float acc[QPL];
          qadc::adc4_code_sum_minor<CB, QPL, kShift>(cur, lane_addr, acc);
          if (cur_code < n) {
#pragma unroll
            for (int i = 0; i < QPL; ++i) {
              if (acc[i] < best[i]) {  // strict: ties keep the lower slot
                best[i] = acc[i];
                arg[i] = k;
              }
            }
          }
        }
      }
      if constexpr (kTransposed) {
#pragma unroll
        for (int i = 0; i < QPL; ++i)
          s_out[(buf * kChunk + lane * QPL + i) * kQmStride + col] = best[i];
      } else if (win < c_total) {
#pragma unroll
        for (int i = 0; i < QPL; ++i) {
          const int q = lane * QPL + i;
          if (q < nq) {
            const size_t o = static_cast<size_t>(win) * q_count + q0 + q;
            out[o] = best[i];  // +inf for a window with no real code
            if constexpr (kWithRows)
              rows_out[o] = arg[i] < 0 ? -1
                                       : slot_code<CB>(ws, blk_base,
                                                       g + arg[i] * ws.groups.d);
          }
        }
      }
    }
    if constexpr (kTransposed) {
      __syncthreads();
      // The tile's minima, a query's 32 windows contiguous. The next tile
      // fills the other buffer, and its barrier comes after every thread has
      // left this loop.
      const int first = tile * kQmTileRows;
      const int here = min(kQmTileRows, c_total - first);
      for (int e = threadIdx.x; e < nq * kQmTileRows; e += kQmThreads) {
        const int q = e / kQmTileRows;
        const int col = e % kQmTileRows;
        if (col < here)
          out[static_cast<size_t>(q0 + q) * c_total + first + col] =
              s_out[(buf * kChunk + q) * kQmStride + col];
      }
    }
  }
}

template <int CB, int QPL, bool kWithRows, bool kTransposed>
cudaError_t launch(const void* codes, const void* tables, void* out, void* rows_out,
                   int c_total, int q_count, int n, const WindowSlots& ws,
                   cudaStream_t stream) {
  using G = FlatQm<CB, QPL>;
  const size_t smem = G::kAlign + G::kTabBytes + (kTransposed ? G::kStageBytes : 0);
  auto kernel = flat_scan_window_qm_kernel<CB, QPL, kWithRows, kTransposed>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (c_total + kQmTileRows - 1) / kQmTileRows;
  const int sms = qadc::sm_count();
  const dim3 grid(tiles < sms ? tiles : sms, (q_count + G::kChunk - 1) / G::kChunk);
  kernel<<<grid, kQmThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(tables),
      static_cast<float*>(out), static_cast<int32_t*>(rows_out), c_total, q_count, n, ws);
  return cudaGetLastError();
}

template <int CB, int QPL>
cudaError_t launch_mode(const void* codes, const void* tables, void* out, void* rows_out,
                        int c_total, int q_count, int n, const WindowSlots& ws,
                        int transpose_out, cudaStream_t stream) {
  if (rows_out)
    return launch<CB, QPL, true, false>(codes, tables, out, rows_out, c_total, q_count, n, ws,
                                        stream);
  if (transpose_out)
    return launch<CB, QPL, false, true>(codes, tables, out, nullptr, c_total, q_count, n, ws,
                                        stream);
  return launch<CB, QPL, false, false>(codes, tables, out, nullptr, c_total, q_count, n, ws,
                                       stream);
}

// chunk: queries a block stages, 32, 64 or (cb 8) 128: lut_scan.flat_scan_chunk.
template <int CB>
cudaError_t launch_chunk(const void* codes, const void* tables, void* out, void* rows_out,
                         int c_total, int q_count, int n, const WindowSlots& ws, int chunk,
                         int transpose_out, cudaStream_t stream) {
  if (chunk == 32)
    return launch_mode<CB, 1>(codes, tables, out, rows_out, c_total, q_count, n, ws,
                              transpose_out, stream);
  if (chunk == 64)
    return launch_mode<CB, 2>(codes, tables, out, rows_out, c_total, q_count, n, ws,
                              transpose_out, stream);
  if constexpr (CB == 8) {
    if (chunk == 128)
      return launch_mode<CB, 4>(codes, tables, out, rows_out, c_total, q_count, n, ws,
                                transpose_out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// codes (N_pad / cpr, 128), tables (Q, 2*cb, 16) float32; out (N_pad / window,
// Q) float32, or (Q, N_pad / window) with transpose_out; rows_out
// (N_pad / window, Q) int32 or null (excludes transpose_out). n: real code
// count, 0 <= n <= n_pad. chunk: lut_scan.flat_scan_chunk.
extern "C" int qadc_flat_scan_window_qm(const void* codes, const void* tables, void* out,
                                        void* rows_out, int n_pad, int q_count, int n,
                                        int block_n, int window, int cb, int chunk,
                                        int transpose_out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((cb != 8 && cb != 16) || q_count < 1 || n_pad < 1 || block_n < 1 || window < 1 ||
      n_pad % block_n != 0 || block_n % window != 0 || block_n % (128 / cb) != 0 ||
      (rows_out && transpose_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const WindowSlots ws{qadc::make_fast_div(static_cast<uint32_t>(block_n / window)),
                       qadc::make_fast_div(static_cast<uint32_t>(block_n / (128 / cb))),
                       block_n, window};
  const int c_total = n_pad / window;
  if (cb == 8)
    return launch_chunk<8>(codes, tables, out, rows_out, c_total, q_count, n, ws, chunk,
                           transpose_out, s);
  return launch_chunk<16>(codes, tables, out, rows_out, c_total, q_count, n, ws, chunk,
                          transpose_out, s);
}
