// Kernels 7 + 8: flat 4-bit ADC scan to per-query row minima with float32
// tables (conventional 4-bit ADC), and optionally the code index of each
// minimum. Int8 tables (Quick ADC) run on the tensor cores (scan_mma.cu,
// scan_wgmma.cu).
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_tq (byte-plane storage)
// and lut_scan_reduce (row128 storage; min-only with transpose_out, or
// with_rows). At the only window the flat index uses, window = min(cpr, 16)
// = cpr (cpr = 128 / CB codes per 128-byte row), window i of both is storage
// row i, so they share one output contract, which this kernel keeps: for
// every query and every storage row, the minimum over the row's codes of
// sum_m T[m][nibble_m] in float32, written per-query ((Q, R), the
// transpose_out layout), and with rows, the argmin's code index, ties to the
// lower code.
//
// Padded codes: codes at or past n never enter a minimum (the port's
// padded-code rule), and a row holding no real code gets +inf and index -1.
// The per-code sum is adc4_sum.cuh's, in rows_adc's order, so a minimum is
// bit for bit the rerank's distance of one of the row's codes.
//
// What bounds it on the H100: shared-memory table lookups and the integer
// work around them, not bytes. Every (query, code) pair costs 2*CB lookups
// (256 per query and row at 16x4 and 32x4 PQ), so 1M codes x 128 queries is
// about 2.1 G lookups, while the codes (8 to 16 MB) are read once per chunk
// of queries and stay in the 50 MB L2.
//
// Design: one thread block per (tile of 128 storage rows, chunk of queries);
// one thread per row, holding its 128 bytes in registers (eight 16-byte
// loads). The chunk's tables are staged in shared memory as [q][m][16]: all
// lanes of a warp look up the same (q, m) row of 16 entries, so their loads
// never conflict. Queries are chunked (slot_chunks.cuh) so that a block stages
// at most 64 KB: a float table of 32 sub-quantizers is 2 KB, and 128 queries
// would not fit one block. Writes to out[q, row] are coalesced across a warp.
//
// Where it runs: its time follows the query count, so it serves below
// lut_scan.QUERY_MINOR_MIN_QUERIES queries, where the query-minor kernel
// (flat_scan_qm.cuh), whose lanes are queries, would idle; and at any batch
// as lut_scan.flat_scan_f32_lookup, which measures that crossover.

#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"
#include "slot_chunks.cuh"

namespace {

constexpr int kRowsPerBlock = 128;

template <int CB, bool kWithRows>
__global__ void __launch_bounds__(kRowsPerBlock)
flat_scan_kernel(const uint8_t* __restrict__ codes,    // (R, 128)
                 const float* __restrict__ tables,     // (Q, 2*CB, 16)
                 float* __restrict__ out,              // (Q, R)
                 int32_t* __restrict__ rows_out,       // (Q, R), kWithRows only
                 int r_count, int q_count, int n, int chunk) {
  constexpr int kTable = 2 * CB * 16;  // entries of one query's table
  constexpr int kVecs = kTable * 4 / 16;
  constexpr int kCpr = 128 / CB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tab = reinterpret_cast<float*>(smem);  // (chunk, 2*CB, 16)

  const int q0 = blockIdx.y * chunk;
  const int nq = min(chunk, q_count - q0);
  const uint4* src = reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(q0) * kVecs;
  for (int i = threadIdx.x; i < nq * kVecs; i += kRowsPerBlock)
    reinterpret_cast<uint4*>(smem)[i] = src[i];
  __syncthreads();

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (row >= r_count) return;
  const int real = n - row * kCpr;  // real codes in this row
  const size_t o = static_cast<size_t>(q0) * r_count + row;
  if (real <= 0) {
    for (int q = 0; q < nq; ++q) {
      out[o + static_cast<size_t>(q) * r_count] = INFINITY;
      if (kWithRows) rows_out[o + static_cast<size_t>(q) * r_count] = -1;
    }
    return;
  }

  uint32_t w[32];
  qadc::load_row(codes + static_cast<size_t>(row) * 128, w);
  for (int q = 0; q < nq; ++q) {
    const float* t = s_tab + q * kTable;
    float best = INFINITY;
    int arg = 0;
#pragma unroll
    for (int c = 0; c < kCpr; ++c) {
      const float acc = qadc::adc4_sum<CB>(w, c, t);
      if (c < real && acc < best) {  // strict: ties keep the lower code
        best = acc;
        arg = c;
      }
    }
    out[o + static_cast<size_t>(q) * r_count] = best;
    if (kWithRows) rows_out[o + static_cast<size_t>(q) * r_count] = row * kCpr + arg;
  }
}

template <int CB, bool kWithRows>
cudaError_t launch(const void* codes, const void* tables, void* out, void* rows_out,
                   int r_count, int q_count, int n, cudaStream_t stream) {
  constexpr int kQueryBytes = 2 * CB * 16 * 4;
  const qadc::SlotChunks chunks = qadc::slot_chunks(q_count, kQueryBytes);
  const size_t smem = static_cast<size_t>(chunks.chunk) * kQueryBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_kernel<CB, kWithRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((r_count + kRowsPerBlock - 1) / kRowsPerBlock, chunks.count);
  flat_scan_kernel<CB, kWithRows><<<grid, kRowsPerBlock, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(tables),
      static_cast<float*>(out), static_cast<int32_t*>(rows_out), r_count, q_count, n,
      chunks.chunk);
  return cudaGetLastError();
}

template <int CB>
cudaError_t launch_rows(const void* codes, const void* tables, void* out, void* rows_out,
                        int r_count, int q_count, int n, cudaStream_t stream) {
  if (rows_out)
    return launch<CB, true>(codes, tables, out, rows_out, r_count, q_count, n, stream);
  return launch<CB, false>(codes, tables, out, nullptr, r_count, q_count, n, stream);
}

}  // namespace

// float32 tables and out. rows_out may be null (minima only). n: real code
// count, 0 <= n <= r_count * cpr.
extern "C" int qadc_flat_scan(const void* codes, const void* tables, void* out,
                              void* rows_out, int r_count, int q_count, int n, int cb,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8) return launch_rows<8>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 16) return launch_rows<16>(codes, tables, out, rows_out, r_count, q_count, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
