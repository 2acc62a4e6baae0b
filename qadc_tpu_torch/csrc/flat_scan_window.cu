// Kernels 8 (general), 8v, 8w and 10: the flat 4-bit ADC scan to window
// minima at any (block_n, window), by two engines.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_reduce in its whole
// contract (any block_n dividing N_pad, any window dividing block_n; minima
// only, transposed or not, or with the argmin's code id; int8 or float32
// tables), and with it lut_scan_topk_int8, which screens its output. The
// reduce kernel's variants "int8", "int8c" and "bf16" differ only in how the
// TPU's matrix unit builds the one-hot pre-image of the codes; this kernel
// builds no one-hot, so all three names run flat_scan_window_kernel.
// flat_scan_window_regs_kernel replaces lut_scan_vpu_reduce: the same int8
// minima, bit for bit, by another engine, kept as an A/B instrument.
//
// Window membership is the JAX kernel's. A block of block_n codes is R =
// block_n / cpr storage rows (cpr = 128 / CB codes a row); slot s = c*R + r
// holds the code at in-block position r*cpr + c; window g of the block is
// slots {g, g + G, 2G + g, ...}, G = block_n / window. A tie goes to the
// lowest SLOT (slots are walked in ascending order with a strict compare),
// which is not always the lowest code id. Codes at or past n never enter a
// minimum (the port's padded-code rule); a window with no real code gets
// 1 << 30 (int8 tables) or +inf (float tables) and id -1. The per-code sum is
// adc4_sum.cuh's, in rows_adc's order, so a float minimum is bit for bit
// the rerank's distance of one of the window's codes.
//
// What bounds them on the H100: table lookups and the integer work around
// them, not bytes: every (query, code) pair costs 2*CB lookups, while the
// codes are read once per chunk of queries and the minima written once.
//
// Design. A thread block stages one code block in shared memory in SLOT
// order (a 16-byte vector of a storage row is one code at CB = 16, two at
// CB = 8), so that neighbouring windows read neighbouring shared-memory
// words, whatever the window.
//   flat_scan_window_kernel: the chunk's tables sit in shared memory as
//     [q][m][16] (slot_chunks.cuh bounds them at 64 KB); a thread takes one
//     (query, window) pair at a time, lanes of a warp on neighbouring
//     windows of one query, so table reads never conflict. Transposed
//     minima are written coalesced; the natural (windows, Q) layout is
//     written with a stride of Q.
//   flat_scan_window_regs_kernel: the engine of the Quick ADC paper. Each
//     thread keeps one query's tables in registers (a 16-entry int8 table is
//     four 32-bit registers: 64 registers at 16 sub-quantizers, 128 at 32)
//     and looks a nibble up with two byte permutes over register pairs and a
//     select on the nibble's top bit. A warp holds 32 queries and walks the
//     block's windows; every lane reads the same code from shared memory (a
//     broadcast), and writes to (windows, Q) are coalesced. The loops over
//     sub-quantizers are fully unrolled, so no table register is indexed at
//     run time.
// Neither uses wgmma or TMA: making them fast is later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"
#include "slot_chunks.cuh"

namespace {

using qadc::Acc;

constexpr int kThreads = 256;     // flat_scan_window_kernel
constexpr int kRegThreads = 128;  // flat_scan_window_regs_kernel: 4 warps of 32 queries

// Copies code block `blk` (rows_per_block storage rows) to shared memory in
// slot order: the code of row r, in-row position c goes to slot c*R + r.
template <int CB>
__device__ __forceinline__ void stage_block_slots(const uint8_t* __restrict__ codes, int blk,
                                                  int rows_per_block, unsigned char* s_codes) {
  const uint4* src =
      reinterpret_cast<const uint4*>(codes) + static_cast<size_t>(blk) * rows_per_block * 8;
  for (int i = threadIdx.x; i < rows_per_block * 8; i += blockDim.x) {
    const int r = i >> 3;  // storage row of the block
    const int v = i & 7;   // 16-byte vector of the row
    const uint4 x = src[i];
    if constexpr (CB == 16) {
      reinterpret_cast<uint4*>(s_codes)[v * rows_per_block + r] = x;
    } else {
      uint2* dst = reinterpret_cast<uint2*>(s_codes);
      dst[(2 * v) * rows_per_block + r] = make_uint2(x.x, x.y);
      dst[(2 * v + 1) * rows_per_block + r] = make_uint2(x.z, x.w);
    }
  }
}

// The CB / 4 words of the code in `slot`.
template <int CB>
__device__ __forceinline__ void load_slot(const unsigned char* s_codes, int slot,
                                          uint32_t (&cw)[CB / 4]) {
  if constexpr (CB == 16) {
    const uint4 v = reinterpret_cast<const uint4*>(s_codes)[slot];
    cw[0] = v.x;
    cw[1] = v.y;
    cw[2] = v.z;
    cw[3] = v.w;
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(s_codes)[slot];
    cw[0] = v.x;
    cw[1] = v.y;
  }
}

// In-block code position of a slot (slots_to_rows).
template <int CB>
__device__ __forceinline__ int slot_code(int slot, int rows_per_block) {
  return (slot % rows_per_block) * (128 / CB) + slot / rows_per_block;
}

template <int CB, typename T, bool kWithRows>
__global__ void __launch_bounds__(kThreads)
flat_scan_window_kernel(const uint8_t* __restrict__ codes,         // (N_pad / cpr, 128)
                        const T* __restrict__ tables,              // (Q, 2*CB, 16)
                        typename Acc<T>::type* __restrict__ out,   // (C, Q) or (Q, C)
                        int32_t* __restrict__ rows_out,            // (C, Q), kWithRows only
                        int n_pad, int q_count, int n, int block_n, int window, int chunk,
                        int transpose_out) {
  using A = typename Acc<T>::type;
  constexpr int kTable = 2 * CB * 16;  // entries of one query's table
  constexpr int kVecs = kTable * static_cast<int>(sizeof(T)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_codes = smem;                                   // (block_n, CB), slot order
  T* s_tab = reinterpret_cast<T*>(smem + static_cast<size_t>(block_n) * CB);  // (chunk, 2*CB, 16)

  const int rows_per_block = block_n / (128 / CB);
  const int groups = block_n / window;  // windows of one code block
  const int blk = blockIdx.x;
  const int q0 = blockIdx.y * chunk;
  const int nq = min(chunk, q_count - q0);
  const uint4* src = reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(q0) * kVecs;
  for (int i = threadIdx.x; i < nq * kVecs; i += kThreads)
    reinterpret_cast<uint4*>(s_tab)[i] = src[i];
  stage_block_slots<CB>(codes, blk, rows_per_block, s_codes);
  __syncthreads();

  const int base = blk * block_n;
  const bool all_real = base + block_n <= n;  // no padded code in this block
  const size_t c_total = static_cast<size_t>(n_pad / window);
  for (int item = threadIdx.x; item < groups * nq; item += kThreads) {
    const int q = item / groups;
    const int g = item - q * groups;
    const T* t = s_tab + q * kTable;
    A best = Acc<T>::none();
    int arg = -1;
    for (int w = 0; w < window; ++w) {
      const int slot = g + w * groups;
      if (!all_real && base + slot_code<CB>(slot, rows_per_block) >= n) continue;
      uint32_t cw[CB / 4];
      load_slot<CB>(s_codes, slot, cw);
      const A acc = qadc::adc4_code_sum<CB>(cw, t);
      if (acc < best) {  // strict: ties keep the lower slot
        best = acc;
        arg = slot;
      }
    }
    const size_t win = static_cast<size_t>(blk) * groups + g;
    const size_t o = transpose_out ? static_cast<size_t>(q0 + q) * c_total + win
                                   : win * q_count + q0 + q;
    out[o] = arg < 0 ? Acc<T>::trim() : best;
    if (kWithRows) rows_out[o] = arg < 0 ? -1 : base + slot_code<CB>(arg, rows_per_block);
  }
}

// Entry x (< 16) of a 16-entry int8 table held in four registers.
__device__ __forceinline__ int lut16(const uint4& t, uint32_t x) {
  const uint32_t sel = x & 7u;
  const uint32_t lo = __byte_perm(t.x, t.y, sel);  // byte 0: entry sel of entries 0..7
  const uint32_t hi = __byte_perm(t.z, t.w, sel);  // byte 0: entry 8 + sel
  return static_cast<int8_t>(((x & 8u) ? hi : lo) & 0xFFu);
}

template <int CB>
__global__ void __launch_bounds__(kRegThreads)
flat_scan_window_regs_kernel(const uint8_t* __restrict__ codes,    // (N_pad / cpr, 128)
                             const int8_t* __restrict__ tables,    // (Q, 2*CB, 16)
                             int32_t* __restrict__ out,            // (C, Q)
                             int q_count, int n, int block_n, int window) {
  extern __shared__ __align__(16) unsigned char smem[];  // (block_n, CB), slot order
  const int rows_per_block = block_n / (128 / CB);
  const int groups = block_n / window;
  const int blk = blockIdx.x;
  const int q = blockIdx.y * kRegThreads + threadIdx.x;

  uint4 tab[2 * CB];  // this query's tables: registers (every index below is a constant)
  const uint4* src =
      reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(min(q, q_count - 1)) * 2 * CB;
#pragma unroll
  for (int m = 0; m < 2 * CB; ++m) tab[m] = src[m];
  stage_block_slots<CB>(codes, blk, rows_per_block, smem);
  __syncthreads();
  if (q >= q_count) return;

  const int base = blk * block_n;
  const bool all_real = base + block_n <= n;
  for (int g = 0; g < groups; ++g) {
    int best = INT_MAX;
    for (int w = 0; w < window; ++w) {
      const int slot = g + w * groups;
      if (!all_real && base + slot_code<CB>(slot, rows_per_block) >= n) continue;
      uint32_t cw[CB / 4];
      load_slot<CB>(smem, slot, cw);  // one address for the whole warp: a broadcast
      int acc = 0;
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const uint32_t byte = (cw[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
        acc += lut16(tab[2 * b], byte & 15u);
        acc += lut16(tab[2 * b + 1], byte >> 4);
      }
      best = min(best, acc);
    }
    out[(static_cast<size_t>(blk) * groups + g) * q_count + q] =
        best == INT_MAX ? Acc<int8_t>::trim() : best;
  }
}

template <int CB, typename T, bool kWithRows>
cudaError_t launch_window(const void* codes, const void* tables, void* out, void* rows_out,
                          int n_pad, int q_count, int n, int block_n, int window,
                          int transpose_out, cudaStream_t stream) {
  constexpr int kQueryBytes = 2 * CB * 16 * static_cast<int>(sizeof(T));
  const qadc::SlotChunks chunks = qadc::slot_chunks(q_count, kQueryBytes);
  const size_t smem =
      static_cast<size_t>(block_n) * CB + static_cast<size_t>(chunks.chunk) * kQueryBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_window_kernel<CB, T, kWithRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_pad / block_n, chunks.count);
  flat_scan_window_kernel<CB, T, kWithRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const T*>(tables),
      static_cast<typename Acc<T>::type*>(out), static_cast<int32_t*>(rows_out), n_pad,
      q_count, n, block_n, window, chunks.chunk, transpose_out);
  return cudaGetLastError();
}

template <int CB, typename T>
cudaError_t launch_window_rows(const void* codes, const void* tables, void* out,
                               void* rows_out, int n_pad, int q_count, int n, int block_n,
                               int window, int transpose_out, cudaStream_t stream) {
  if (rows_out)
    return launch_window<CB, T, true>(codes, tables, out, rows_out, n_pad, q_count, n,
                                      block_n, window, transpose_out, stream);
  return launch_window<CB, T, false>(codes, tables, out, nullptr, n_pad, q_count, n, block_n,
                                     window, transpose_out, stream);
}

template <int CB>
cudaError_t launch_regs(const void* codes, const void* tables, void* out, int n_pad,
                        int q_count, int n, int block_n, int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_n) * CB;
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_window_regs_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_pad / block_n, (q_count + kRegThreads - 1) / kRegThreads);
  flat_scan_window_regs_kernel<CB><<<grid, kRegThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<int32_t*>(out), q_count, n, block_n, window);
  return cudaGetLastError();
}

// The shapes both kernels take: whole code blocks of whole storage rows,
// whole windows.
bool legal(int n_pad, int q_count, int block_n, int window, int cb) {
  if (cb != 8 && cb != 16) return false;
  if (q_count < 1 || n_pad < 1 || block_n < 1 || window < 1) return false;
  return n_pad % block_n == 0 && block_n % window == 0 && block_n % (128 / cb) == 0;
}

}  // namespace

// f32 == 0: int8 tables, int32 out; f32 != 0: float32 tables and out. out is
// (N_pad / window, Q), or (Q, N_pad / window) with transpose_out; rows_out
// (N_pad / window, Q) may be null (minima only) and excludes transpose_out.
// n: real code count, 0 <= n <= n_pad.
extern "C" int qadc_flat_scan_window(const void* codes, const void* tables, void* out,
                                     void* rows_out, int n_pad, int q_count, int n,
                                     int block_n, int window, int cb, int f32,
                                     int transpose_out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!legal(n_pad, q_count, block_n, window, cb) || (rows_out && transpose_out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && !f32)
    return launch_window_rows<8, int8_t>(codes, tables, out, rows_out, n_pad, q_count, n,
                                         block_n, window, transpose_out, s);
  if (cb == 16 && !f32)
    return launch_window_rows<16, int8_t>(codes, tables, out, rows_out, n_pad, q_count, n,
                                          block_n, window, transpose_out, s);
  if (cb == 8)
    return launch_window_rows<8, float>(codes, tables, out, rows_out, n_pad, q_count, n,
                                        block_n, window, transpose_out, s);
  return launch_window_rows<16, float>(codes, tables, out, rows_out, n_pad, q_count, n,
                                       block_n, window, transpose_out, s);
}

// int8 tables, int32 minima (N_pad / window, Q).
extern "C" int qadc_flat_scan_window_regs(const void* codes, const void* tables, void* out,
                                          int n_pad, int q_count, int n, int block_n,
                                          int window, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!legal(n_pad, q_count, block_n, window, cb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8)
    return launch_regs<8>(codes, tables, out, n_pad, q_count, n, block_n, window, s);
  return launch_regs<16>(codes, tables, out, n_pad, q_count, n, block_n, window, s);
}
