// Kernel 9: flat 8-bit conventional-ADC scan to per-query window minima and
// the code index of each window's minimum.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan8_reduce as the flat index
// calls it (block_n 256, window W = 16, transpose_out). Its output contract,
// which this kernel keeps: for every query and every window, the minimum over
// the window's codes of sum_b T[b][code byte b], the tables in bf16 and the
// sums in float32 over b = 0..M-1, written per query ((Q, N_pad / 16)), and
// the argmin's code index (the Pallas kernel's argmin slot mapped through
// slots_to_rows). Ties go to the lower code.
//
// Windows are the JAX membership, which depends on M (cpr = 128 / M codes a
// 128-byte row): in 256-code block b, window b*16 + j holds the codes of
// slots {w*16 + j : w < 16}, slot s being code b*256 + (s % R)*cpr + s / R
// with R = 256 / cpr rows a block. So a window is storage row j at M = 8;
// rows j and j + 16 at M = 16; rows j, j + 16, j + 32, j + 48 at M = 32; and
// the positions of parity j / 8 in row j % 8 at M = 4. Codes at or past n
// never enter a minimum (the port's padded-code rule; the reference masks a
// window whose argmin is padding instead, which can hide the real codes of
// that window); a window with no real code gets +inf and index -1.
//
// What bounds it on the H100: data-dependent 256-entry lookups in shared
// memory (M per code and query, with bank conflicts between the lanes of a
// warp), not device-memory bytes: the codes (8 to 32 bytes each) are read
// once per chunk of queries.
//
// Design: a thread block of 256 threads scans kBlocksPerCta consecutive
// 256-code blocks for one chunk of queries, whose bf16 tables it stages once
// in shared memory as [q][b][256] (M * 512 bytes a query; queries are chunked
// to fit, slot_chunks.cuh). Thread t serves window t / 16 of the current code
// block, holding the code of rank t % 16 among the window's 16 members in
// code order, so the 16 members of a window are the 16 lanes of a half-warp.
// Per query each lane sums its code; the half-warp's minimum comes from four
// xor shuffles, and its argmin, ties to the lower code, is the lowest lane
// holding the minimum (a ballot).
//
// Where it runs: its time follows the query count, so it serves batches below
// lut_scan.QUERY_MINOR_MIN_QUERIES8 queries, where the query-minor kernel
// (flat_scan8_qm.cuh), whose lanes are queries, would idle; and at any batch
// as lut_scan.flat_scan8_lookup, which measures that crossover.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "slot_chunks.cuh"

namespace {

constexpr int kThreads = 256;      // one 256-code block: 16 windows x 16 members
constexpr int kBlocksPerCta = 8;   // code blocks a thread block scans per table staging

template <int W>
struct Words;  // one code's W 32-bit words
template <>
struct Words<1> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
};
template <>
struct Words<2> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct Words<4> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};
template <>
struct Words<8> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    Words<4>::load(p, w);
    Words<4>::load(p + 16, w + 4);
  }
};

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// In-block index of the member of rank l (code order) of window j.
template <int M>
__device__ __forceinline__ int member(int j, int l) {
  constexpr int kCpr = 128 / M;
  if (kCpr == 32) return (j & 7) * 32 + 2 * l + (j >> 3);  // one row, one parity
  return (j + 16 * (l / kCpr)) * kCpr + l % kCpr;            // 16 / cpr whole rows
}

// kConstCode (the scan lab): every lookup at code byte 0x5A, so the lanes of a
// warp read one entry and no load conflicts; its output is not the scan's.
template <int M, bool kConstCode>
__global__ void __launch_bounds__(kThreads)
flat_scan8_kernel(const uint8_t* __restrict__ codes,     // (N_pad, M) as row128 storage
                  const uint16_t* __restrict__ tables,   // (Q, M, 256) bf16
                  float* __restrict__ out_min,           // (Q, N_pad / 16)
                  int32_t* __restrict__ out_idx,         // (Q, N_pad / 16)
                  int n_blocks, int q_count, int n, int chunk, uint32_t const_keep) {
  constexpr int kTable = M * 256;  // entries of one query's table
  constexpr int kVecs = kTable * 2 / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* s_tab = reinterpret_cast<const uint16_t*>(smem);  // (chunk, M, 256)

  const int q0 = blockIdx.y * chunk;
  const int nq = min(chunk, q_count - q0);
  const uint4* src = reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(q0) * kVecs;
  for (int i = threadIdx.x; i < nq * kVecs; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = src[i];
  __syncthreads();

  const int j = threadIdx.x >> 4;         // window of the code block
  const int l = threadIdx.x & 15;         // rank of this lane's member
  const int half = threadIdx.x & 16;      // first lane of this half-warp
  const int local = member<M>(j, l);
  const size_t windows = static_cast<size_t>(n_blocks) * 16;
  const int first_blk = blockIdx.x * kBlocksPerCta;
  const int last_blk = min(n_blocks, first_blk + kBlocksPerCta);
  for (int blk = first_blk; blk < last_blk; ++blk) {  // uniform across the block
    const int code = blk * 256 + local;
    const bool real = code < n;
    uint32_t w[M / 4];
    Words<M / 4>::load(codes + static_cast<size_t>(code) * M, w);
    if (kConstCode) {
#pragma unroll
      for (int k = 0; k < M / 4; ++k) w[k] = (w[k] & const_keep) | 0x5A5A5A5Au;
    }
    const size_t o = static_cast<size_t>(q0) * windows + blk * 16 + j;
    for (int q = 0; q < nq; ++q) {
      const uint16_t* t = s_tab + q * kTable;
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < M; ++b) {
        const uint32_t byte = (w[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
        acc += bf16_to_float(t[b * 256 + byte]);
      }
      const float v = real ? acc : INFINITY;
      float best = v;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
      const unsigned tied = __ballot_sync(0xffffffffu, v == best) >> half & 0xFFFFu;
      if (l == 0) {
        out_min[o + q * windows] = best;
        out_idx[o + q * windows] =
            best == INFINITY ? -1 : blk * 256 + member<M>(j, __ffs(tied) - 1);
      }
    }
  }
}

template <int M, bool kConstCode = false>
cudaError_t launch(const void* codes, const void* tables, void* out_min, void* out_idx,
                   int n_blocks, int q_count, int n, cudaStream_t stream) {
  constexpr int kQueryBytes = M * 256 * 2;
  const qadc::SlotChunks chunks = qadc::slot_chunks(q_count, kQueryBytes);
  const size_t smem = static_cast<size_t>(chunks.chunk) * kQueryBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan8_kernel<M, kConstCode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_blocks + kBlocksPerCta - 1) / kBlocksPerCta, chunks.count);
  flat_scan8_kernel<M, kConstCode><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint16_t*>(tables),
      static_cast<float*>(out_min), static_cast<int32_t*>(out_idx), n_blocks, q_count, n,
      chunks.chunk, 0u);
  return cudaGetLastError();
}

}  // namespace

// n_blocks: 256-code blocks (N_pad / 256); n: real code count.
extern "C" int qadc_flat_scan8(const void* codes, const void* tables, void* out_min,
                               void* out_idx, int n_blocks, int q_count, int n, int m,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 4) return launch<4>(codes, tables, out_min, out_idx, n_blocks, q_count, n, s);
  if (m == 8) return launch<8>(codes, tables, out_min, out_idx, n_blocks, q_count, n, s);
  if (m == 16) return launch<16>(codes, tables, out_min, out_idx, n_blocks, q_count, n, s);
  if (m == 32) return launch<32>(codes, tables, out_min, out_idx, n_blocks, q_count, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scan lab's const_code mode of the kernel above at m = 8 (same arguments).
extern "C" int qadc_flat_scan8_const_code(const void* codes, const void* tables, void* out_min,
                                          void* out_idx, int n_blocks, int q_count, int n,
                                          void* stream) {
  if (q_count < 1 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<8, true>(codes, tables, out_min, out_idx, n_blocks, q_count, n,
                         static_cast<cudaStream_t>(stream));
}
