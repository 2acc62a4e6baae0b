// Kernel 9, query-minor: the flat 8-bit conventional-ADC scan to per-query
// window minima and the code index of each window's minimum. The same
// contract, bit for bit, as flat_scan8.cu, which it replaces from
// lut_scan.QUERY_MINOR_MIN_QUERIES8 queries on.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan8_reduce as the flat index
// calls it (block_n 256, window 16, transpose_out); see flat_scan8.cu for the
// contract: the JAX window membership at M = 4, 8, 16, 32, bf16 tables summed
// in float32 over b = 0..M-1, ties to the lower code, codes at or past n in no
// minimum, +inf and -1 for a window with no real code.
//
// What bounds it on the H100: shared-memory wavefronts and the instructions
// around a lookup, not bytes. The code-a-thread kernel loaded at 32 data-
// dependent offsets of a 512-byte table row (about 3.4 wavefronts a load)
// and paid four shuffles and a ballot for every eight lookups.
//
// Design: a lane is two queries, a code is uniform across its lane group.
//   - The tables of a chunk of CHUNK queries (8 to 64, what 128 KB hold at
//     M * 512 bytes a query) lie in shared memory query-minor,
//     [b][256][query] bf16: the staging loop transposes them from their
//     global (Q, M, 256) layout. One persistent block of 16 warps an SM
//     stages once and walks a contiguous range of 256-code blocks.
//   - A lookup is one 4-byte load of a bf16 pair (the lane's two queries) at
//     ((b * 256 + byte) * CHUNK + 2 * lane) * 2: the CHUNK / 2 lanes of a
//     group read one entry's consecutive bytes. A warp holds 64 / CHUNK
//     groups, each on the same window of another 256-code block.
//   - Warp j takes window j of its blocks. A group walks the window's 16
//     members in code order (flat8_members' order: one 128-byte storage row
//     a step, every lane of the group loading the same 16 bytes) and keeps
//     its queries' running minima with a strict <: no shuffles, no ballot.
//     The next step's row is loaded before the current one is summed.
//   - out[q, window] with q across lanes would be strided by the window
//     count, so a tile of 4 x 64 / CHUNK blocks' windows is staged in shared
//     memory (two buffers: one barrier a tile) and written window-contiguous.
// MODE removes parts for the scan lab (kernels/scan_lab.py).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"    // load_row, field_offset
#include "flat_scan_qm.cuh"  // QmMode, sm_count

namespace qadc {

constexpr int kQm8Threads = 512;
constexpr int kQm8GroupsPerTile = 4;  // block groups a tile stages before it is written

template <int M, int CHUNK>
struct Flat8Qm {
  static constexpr int kLanes = CHUNK / 2;             // lanes of a group: two queries a lane
  static constexpr int kGroups = 32 / kLanes;          // groups a warp: 256-code blocks in step
  static constexpr int kCpr = 128 / M;
  static constexpr int kSteps = kCpr >= 16 ? 1 : 16 / kCpr;  // storage rows a window
  static constexpr int kCodes = 16 / kSteps;           // members a step
  static constexpr int kBlockRows = 256 / kCpr;        // storage rows of a 256-code block
  static constexpr int kTileBlocks = kGroups * kQm8GroupsPerTile;
  static constexpr int kTileWindows = 16 * kTileBlocks;
  static constexpr int kStride = kTileWindows + 1;     // staging row, padded
  static constexpr int kShift =                        // log2 of one entry's bytes
      CHUNK == 8 ? 4 : CHUNK == 16 ? 5 : CHUNK == 32 ? 6 : 7;
  static constexpr uint32_t kEntryBytes = CHUNK * 2u;
  static constexpr uint32_t kTabBytes = M * 256u * kEntryBytes;
  static constexpr uint32_t kAlign = 256u * kEntryBytes;  // one sub-quantizer's entries
  static constexpr uint32_t kStageBytes = 2u * CHUNK * kStride * 4u;  // one of minima, indices
  static constexpr size_t kSmem = kAlign + kTabBytes + 2 * kStageBytes;
  static_assert(CHUNK == 8 || CHUNK == 16 || CHUNK == 32 || CHUNK == 64, "chunk");
};

template <int M, int CHUNK, int MODE>
__global__ void __launch_bounds__(kQm8Threads, 1)
flat_scan8_qm_kernel(const uint8_t* __restrict__ codes,     // (N_pad, M) as row128 storage
                     const uint16_t* __restrict__ tables,   // (Q, M, 256) bf16
                     float* __restrict__ out_min,           // (Q, N_pad / 16)
                     int32_t* __restrict__ out_idx,         // (Q, N_pad / 16)
                     int n_blocks, int q_count, int n, uint32_t keep, uint32_t fixed) {
  using G = Flat8Qm<M, CHUNK>;
  constexpr int kVecs = M * 256 / 8;  // 16-byte vectors of one query's table
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t tab = (base + G::kAlign - 1) & ~(G::kAlign - 1);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem + (tab - base));       // [M*256][CHUNK]
  float* s_min = reinterpret_cast<float*>(smem + (tab - base) + G::kTabBytes);  // [2][CHUNK][stride]
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_min + 2 * CHUNK * G::kStride);

  const int q0 = blockIdx.y * CHUNK;
  const int nq = min(CHUNK, q_count - q0);
  const uint4* src = reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(q0) * kVecs;
  for (int i = threadIdx.x; i < CHUNK * kVecs; i += kQm8Threads) {
    const int q = i % CHUNK;
    const int vec = i / CHUNK;
    const uint4 v = q < nq ? src[static_cast<size_t>(q) * kVecs + vec] : make_uint4(0, 0, 0, 0);
    uint16_t* dst = s_tab + (vec * 8) * CHUNK + q;
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dst[(2 * k) * CHUNK] = static_cast<uint16_t>(words[k] & 0xFFFFu);
      dst[(2 * k + 1) * CHUNK] = static_cast<uint16_t>(words[k] >> 16);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;              // the window of a block this warp takes
  const int sub = lane / G::kLanes;            // the lane's group
  const int ql = lane % G::kLanes;             // queries 2 * ql and 2 * ql + 1 of the chunk
  const uint32_t lane_addr = tab + ql * 4;
  const int parity = j >> 3;                   // M = 4: the in-row parity of window j
  // This thread block's range of 256-code blocks, as even as they come.
  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) * n_blocks / gridDim.x);
  const int b1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_blocks / gridDim.x);
  const int groups = (b1 - b0 + G::kGroups - 1) / G::kGroups;
  const int total = groups * G::kSteps;        // steps: one storage row a group each
  const size_t windows = static_cast<size_t>(n_blocks) * 16;

  float best[2];
  int arg[2];

  auto block_of = [&](int step) { return b0 + (step / G::kSteps) * G::kGroups + sub; };
  auto load = [&](uint32_t (&w)[32], int step) {
    const int blk = block_of(step);
    const int k = step % G::kSteps;
    const int row = G::kCpr == 32 ? (j & 7) : j + 16 * k;
    if (blk < b1) {
      load_row(codes + (static_cast<size_t>(blk) * G::kBlockRows + row) * 128, w);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) w[i] = 0;
    }
  };
  auto compute = [&](uint32_t (&w)[32], int step) {
    const int grp = step / G::kSteps;
    const int k = step % G::kSteps;
    const int blk = block_of(step);
    const int lim = blk < b1 ? n - blk * 256 : 0;  // real codes of this block
    if (k == 0) {
      best[0] = best[1] = MODE == kQmNoMin ? 0.0f : INFINITY;
      arg[0] = arg[1] = 0;
    }
    if (MODE == kQmCopy) {
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) bits += __popc(w[i]);
      if (bits > 1024u) best[0] = 0.0f;  // never: keeps the loads
    } else {
      if (MODE == kQmConstCode) {
#pragma unroll
        for (int i = 0; i < 32; ++i) w[i] = (w[i] & keep) | fixed;
      }
#pragma unroll
      for (int i = 0; i < G::kCodes; ++i) {
        float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
        for (int b = 0; b < M; ++b) {
          const uint32_t word = M == 4 ? (parity ? w[2 * i + 1] : w[2 * i])
                                       : w[(i * M + b) >> 2];
          uint32_t pair;
          asm volatile("ld.shared.u32 %0, [%1];"
                       : "=r"(pair)
                       : "r"((field_offset<G::kShift>(word, (b & 3) * 8, 255u) | lane_addr) +
                             b * G::kAlign));
          acc0 += __uint_as_float(pair << 16);
          acc1 += __uint_as_float(pair & 0xFFFF0000u);
        }
        const int local = G::kCpr == 32 ? (j & 7) * 32 + 2 * i + parity
                                        : (j + 16 * k) * G::kCpr + i;
        if (MODE == kQmNoMin) {
          best[0] += acc0;
          best[1] += acc1;
        } else if (local < lim) {  // strict minima: ties keep the lower code
          if (acc0 < best[0]) {
            best[0] = acc0;
            arg[0] = local;
          }
          if (acc1 < best[1]) {
            best[1] = acc1;
            arg[1] = local;
          }
        }
      }
    }
    if (k == G::kSteps - 1) {
      const int buf = (grp / kQm8GroupsPerTile) & 1;
      const int col = ((grp % kQm8GroupsPerTile) * G::kGroups + sub) * 16 + j;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = (buf * CHUNK + 2 * ql + e) * G::kStride + col;
        s_min[o] = best[e];
        s_idx[o] = best[e] == INFINITY ? -1 : blk * 256 + arg[e];
      }
    }
  };
  // After a tile's last step (or the range's): the tile's windows, a query's
  // contiguous. The next tile fills the other buffer, and its barrier comes
  // after every thread has left this loop.
  auto flush = [&](int step) {
    const int grp = step / G::kSteps;
    if (step % G::kSteps != G::kSteps - 1) return;
    if ((grp + 1) % kQm8GroupsPerTile != 0 && grp != groups - 1) return;
    __syncthreads();
    const int tile = grp / kQm8GroupsPerTile;
    const int buf = tile & 1;
    const int first_blk = b0 + tile * G::kTileBlocks;
    const int here = min(G::kTileBlocks, b1 - first_blk) * 16;
    const size_t w0 = static_cast<size_t>(first_blk) * 16;
    for (int e = threadIdx.x; e < nq * G::kTileWindows; e += kQm8Threads) {
      const int q = e / G::kTileWindows;
      const int col = e % G::kTileWindows;
      if (col < here) {
        const size_t o = static_cast<size_t>(q0 + q) * windows + w0 + col;
        out_min[o] = s_min[(buf * CHUNK + q) * G::kStride + col];
        out_idx[o] = s_idx[(buf * CHUNK + q) * G::kStride + col];
      }
    }
  };

  uint32_t wa[32], wb[32];
  if (total > 0) load(wa, 0);
  for (int step = 0; step < total; step += 2) {  // uniform across the block
    if (step + 1 < total) load(wb, step + 1);
    compute(wa, step);
    flush(step);
    if (step + 2 < total) load(wa, step + 2);
    if (step + 1 < total) {
      compute(wb, step + 1);
      flush(step + 1);
    }
  }
}

template <int M, int CHUNK, int MODE>
cudaError_t launch_flat8_qm(const void* codes, const void* tables, void* out_min, void* out_idx,
                            int n_blocks, int q_count, int n, cudaStream_t stream) {
  using G = Flat8Qm<M, CHUNK>;
  auto kernel = flat_scan8_qm_kernel<M, CHUNK, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  const dim3 grid(n_blocks < sms ? n_blocks : sms, (q_count + CHUNK - 1) / CHUNK);
  // Lab mode const_code: every code byte 0x5A.
  kernel<<<grid, kQm8Threads, G::kSmem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint16_t*>(tables),
      static_cast<float*>(out_min), static_cast<int32_t*>(out_idx), n_blocks, q_count, n, 0u,
      0x5A5A5A5Au);
  return cudaGetLastError();
}

// chunk: queries a block stages (lut_scan.query_minor_chunk): a power of two
// from 8 to 65536 / (M * 256), what 128 KB of bf16 tables hold.
template <int M, int MODE>
cudaError_t launch_flat8_qm_chunk(const void* codes, const void* tables, void* out_min,
                                  void* out_idx, int n_blocks, int q_count, int n, int chunk,
                                  cudaStream_t stream) {
  if (chunk == 8)
    return launch_flat8_qm<M, 8, MODE>(codes, tables, out_min, out_idx, n_blocks, q_count, n,
                                       stream);
  if constexpr (M <= 16) {
    if (chunk == 16)
      return launch_flat8_qm<M, 16, MODE>(codes, tables, out_min, out_idx, n_blocks, q_count, n,
                                          stream);
  }
  if constexpr (M <= 8) {
    if (chunk == 32)
      return launch_flat8_qm<M, 32, MODE>(codes, tables, out_min, out_idx, n_blocks, q_count, n,
                                          stream);
  }
  if constexpr (M <= 4) {
    if (chunk == 64)
      return launch_flat8_qm<M, 64, MODE>(codes, tables, out_min, out_idx, n_blocks, q_count, n,
                                          stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace qadc
