// Kernel 10: the flat 4-bit Quick ADC scan to window minima with the tables
// in registers, four lookups a byte permute: the register engine of the
// Quick ADC paper (pshufb) on the H100's byte permute (PTX prmt).
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_vpu_reduce (body
// _scan_min_vpu_kernel): int8 tables, min-only (N_pad / W, Q) int32 minima,
// bit for bit flat_scan_window's, 1 << 30 for a window with no real code.
//
// What bounds it on the H100: integer instructions. Every (query, code) pair
// costs 2*CB lookups, and an SM issues 64 integer lanes a clock, so the
// instructions a lookup takes set the time; the tables never leave the
// registers and the codes are read once a block of 128 queries.
//
// Design:
//   - Nibble planes. A block stages its code block in shared memory so that
//     word (j, m) holds sub-quantizer m's nibbles of the 8 consecutive slots
//     8j .. 8j + 7, slot 8j + i at bits 4i (the transposed block layout of
//     Quick ADC). Slot s = c*R + r is the code at in-block position
//     r*cpr + c, as in flat_scan_window.cu.
//   - Eight windows a lane. At rank k, slots kG + g0 .. kG + g0 + 7 are rank
//     k of the adjacent windows g0 .. g0 + 7 (G = block_n / W windows a
//     block), so a lane walks 8 windows at once, W ranks, each window's
//     minimum in its own lane: no shuffles. Where 8 does not divide kG + g0
//     the rank's word is a funnel shift of two plane words, and lanes past
//     the block's last window are masked (any G).
//   - G = 1, 2 or 4: the 8 slots of a plane word fall into windows i % G, so
//     a lane walks the plane words in order and folds its 8 lanes into the
//     G windows at the end.
//   - Four lookups a permute. A 16-entry table is four registers; for four
//     nibbles x (one 16-bit half of a plane word), a byte permute over
//     (t.x, t.y) with the nibbles as selector looks up entries 0-7, one over
//     (t.z, t.w) with bit 3 flipped entries 8-15, and a LOP3 keeps, byte by
//     byte, the one that each nibble's bit 3 names; the mask is a third
//     permute, replicating the signs of x << 4 and x. A nibble whose bit 3
//     is set makes the first permute replicate a sign where it is not kept,
//     so no selector is masked: ptxas re-masks a masked selector to 16
//     bits, a LOP3 apiece (masked selectors and a pick permute of 0x3210 +
//     4 * bit 3 compiled to 3.1-3.2 integer instructions a lookup over the
//     whole loop, these to 2.4-2.6, and to 2.2-2.3 on the loop's path
//     without funnel shifts: PERF.md, kernel 10).
//   - Sums in 16-bit lanes. The entries are biased to unsigned (XOR 0x80)
//     when they are loaded into registers; the even and odd bytes of a
//     looked-up word go to two words of two 16-bit lanes each, and one
//     32-bit add (ptxas makes some of them IMADs, on the FMA pipe) sums two
//     lanes: 2*CB entries of at most 255 stay below 65535, so no carry
//     crosses a lane. Minima are taken per 16-bit lane (__vminu2), a lane
//     whose code is padding (bits staged with the planes) being 0xFFFF
//     first; 128 * 2*CB comes off at the end.
// One warp holds 32 queries, a block 128; every lane of a warp reads the
// same plane words (a broadcast), and writes to (windows, Q) are coalesced.
// The loops over sub-quantizers are fully unrolled, so no table register is
// indexed at run time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps of 32 queries
constexpr uint32_t kEmpty = 0xFFFFu;  // a 16-bit lane that holds no real code

// Slot `slot`'s code in its block: slot s = c*R + r is position r*cpr + c.
template <int CB>
__device__ __forceinline__ int slot_pos(int slot, int rows_per_block) {
  return (slot % rows_per_block) * (128 / CB) + slot / rows_per_block;
}

// Stages block blk as nibble planes: planes[j * 2*CB + m], j < block_n / 8,
// and one row of zeros past the last (a funnel shift may read it); and
// pad[j], bit i set where slot 8j + i holds a padded code (position at or
// past `real`, the block's real code count), 0 past the last row.
template <int CB>
__device__ __forceinline__ void stage_planes(const uint8_t* __restrict__ codes, int blk,
                                             int block_n, int real, uint32_t* planes,
                                             uint32_t* pad) {
  constexpr int kM = 2 * CB;
  const int rows_per_block = block_n / (128 / CB);
  const uint8_t* base = codes + static_cast<size_t>(blk) * block_n * CB;
  for (int j = threadIdx.x; j < block_n / 8; j += blockDim.x) {
    uint32_t cw[8][CB / 4];
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pos = slot_pos<CB>(8 * j + i, rows_per_block);
      bits |= static_cast<uint32_t>(pos >= real) << i;
      const auto* code = reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(pos) * CB);
#pragma unroll
      for (int v = 0; v < CB / 4; ++v) cw[i][v] = code[v];
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        word |= ((cw[i][m >> 3] >> (4 * (m & 7))) & 15u) << (4 * i);
      planes[j * kM + m] = word;
    }
    pad[j] = bits;
  }
  if (threadIdx.x < kM) planes[(block_n / 8) * kM + threadIdx.x] = 0u;
  if (threadIdx.x == 0) pad[block_n / 8] = 0u;
}

// The 2*CB plane words of slots s .. s + 7 (s < block_n).
template <int CB>
__device__ __forceinline__ void load_words(const uint32_t* planes, int s,
                                           uint32_t (&x)[2 * CB]) {
  constexpr int kM = 2 * CB;
  const int j = s >> 3;
  const int off = s & 7;
  const uint4* row = reinterpret_cast<const uint4*>(planes + j * kM);
#pragma unroll
  for (int v = 0; v < kM / 4; ++v) {
    const uint4 a = row[v];
    x[4 * v] = a.x;
    x[4 * v + 1] = a.y;
    x[4 * v + 2] = a.z;
    x[4 * v + 3] = a.w;
  }
  if (off) {  // the rank's slots straddle two plane words
    const uint4* next = reinterpret_cast<const uint4*>(planes + (j + 1) * kM);
#pragma unroll
    for (int v = 0; v < kM / 4; ++v) {
      const uint4 b = next[v];
      x[4 * v] = __funnelshift_r(x[4 * v], b.x, 4 * off);
      x[4 * v + 1] = __funnelshift_r(x[4 * v + 1], b.y, 4 * off);
      x[4 * v + 2] = __funnelshift_r(x[4 * v + 2], b.z, 4 * off);
      x[4 * v + 3] = __funnelshift_r(x[4 * v + 3], b.w, 4 * off);
    }
  }
}

// v itself, through an empty asm the compiler cannot see into: a value it
// must keep in a register and cannot recompute. Without it the compiler
// re-applies the tables' bias and folds 0x00FF00FF into an immediate in
// every step of the loop (a LOP3 each; PERF.md, kernel 10).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Bytes of hi where mask is 0xFF, of lo where it is 0x00: one LOP3.
__device__ __forceinline__ uint32_t select(uint32_t lo, uint32_t hi, uint32_t mask) {
  return (hi & mask) | (lo & ~mask);
}

// PTX prmt.b32 in its default mode: byte k of the result is byte c[4k+2:4k]
// of (b:a), or that byte's sign replicated (0x00 or 0xFF) where bit 4k+3 of
// c is set. CUDA's __byte_perm does not replicate signs, so the select mask
// below is written in PTX.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Biased sums of the 8 slots of words x: acc[0] = (slot 0, slot 2) as
// (low, high) 16-bit lanes, acc[1] = (1, 3), acc[2] = (4, 6), acc[3] = (5, 7).
// For 4 nibbles (a 16-bit half of x): entries 0-7 by a permute of (t.x,
// t.y) with the nibbles as selector (a nibble with bit 3 set selects a sign
// there, which the select drops), entries 8-15 by a permute of (t.z, t.w)
// with bit 3 flipped, and the select mask by a sign-replicating permute of
// x << 4 and x, whose byte signs are the nibbles' bits 3: no selector needs
// a mask. one == 1 (a kernel argument): the adds may run as IMADs on the
// FMA pipe.
template <int CB>
__device__ __forceinline__ void lookup8(const uint4 (&tab)[2 * CB], const uint32_t (&x)[2 * CB],
                                        uint32_t one, uint32_t (&acc)[4]) {
  const uint32_t even = opaque(0x00FF00FFu);  // bytes 0 and 2
  acc[0] = acc[1] = acc[2] = acc[3] = 0u;
#pragma unroll
  for (int m = 0; m < 2 * CB; ++m) {
    const uint4 t = tab[m];
    const uint32_t lo_sel = x[m];
    const uint32_t hi_sel = x[m] ^ 0x88888888u;  // bit 3 flipped: the selects of entries 8-15
    const uint32_t signs = x[m] << 4;             // nibble 2i's bit 3 at byte i's bit 7
    const uint32_t r0 = select(prmt(t.x, t.y, lo_sel), prmt(t.z, t.w, hi_sel),
                               prmt(signs, x[m], 0xD9C8u));
    const uint32_t r1 = select(prmt(t.x, t.y, lo_sel >> 16), prmt(t.z, t.w, hi_sel >> 16),
                               prmt(signs, x[m], 0xFBEAu));
    acc[0] += (r0 & even) * one;
    acc[1] += prmt(r0, 0u, 0x4341u) * one;  // bytes 1 and 3, zero-extended
    acc[2] += (r1 & even) * one;
    acc[3] += prmt(r1, 0u, 0x4341u) * one;
  }
}

// 0xFFFF in the lanes of slots s .. s + 7 whose code is padding, in
// lookup8's lane order, from the staged pad bits.
__device__ __forceinline__ void pad_lanes(const uint32_t* pad, int s, uint32_t (&mask)[4]) {
  const int j = s >> 3;
  const uint32_t bits = ((pad[j] | (pad[j + 1] << 8)) >> (s & 7)) & 0xFFu;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mask[(i >> 2) * 2 + (i & 1)] |= ((bits >> i) & 1u) * (kEmpty << (16 * ((i >> 1) & 1)));
}

// The window's minimum from a 16-bit lane: the unbiased sum, or 1 << 30.
template <int CB>
__device__ __forceinline__ int unbias(uint32_t lane) {
  return lane == kEmpty ? (1 << 30) : static_cast<int>(lane) - 128 * 2 * CB;
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
flat_scan_window_perm4_kernel(const uint8_t* __restrict__ codes,    // (N_pad / cpr, 128)
                              const int8_t* __restrict__ tables,    // (Q, 2*CB, 16)
                              int32_t* __restrict__ out,            // (C, Q)
                              int q_count, int n, int block_n, int window, uint32_t one) {
  extern __shared__ __align__(16) uint32_t planes[];  // (block_n / 8 + 1, 2*CB), then pad
  const int groups = block_n / window;
  const int blk = blockIdx.x;
  const int q = blockIdx.y * kThreads + threadIdx.x;

  uint4 tab[2 * CB];  // this query's tables, biased: registers
  const uint4* src =
      reinterpret_cast<const uint4*>(tables) + static_cast<size_t>(min(q, q_count - 1)) * 2 * CB;
#pragma unroll
  for (int m = 0; m < 2 * CB; ++m) {
    const uint4 t = src[m];
    tab[m] = make_uint4(opaque(t.x ^ 0x80808080u), opaque(t.y ^ 0x80808080u),
                        opaque(t.z ^ 0x80808080u), opaque(t.w ^ 0x80808080u));
  }
  const int real = n - blk * block_n;  // real codes of this block (may be <= 0)
  const bool all_real = real >= block_n;
  uint32_t* pad = planes + (block_n / 8 + 1) * 2 * CB;  // (block_n / 8 + 1)
  stage_planes<CB>(codes, blk, block_n, real, planes, pad);
  __syncthreads();
  if (q >= q_count) return;

  int32_t* col = out + static_cast<size_t>(blk) * groups * q_count + q;
  uint32_t acc[4];
  if (groups == 1 || groups == 2 || groups == 4) {
    uint32_t best[4] = {~0u, ~0u, ~0u, ~0u};
    for (int s = 0; s < block_n; s += 8) {
      uint32_t x[2 * CB];
      load_words<CB>(planes, s, x);
      lookup8<CB>(tab, x, one, acc);
      uint32_t mask[4] = {0u, 0u, 0u, 0u};
      if (!all_real) pad_lanes(pad, s, mask);
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = __vminu2(best[i], acc[i] | mask[i]);
    }
    // Lane i of the 8 is window i % G: fold (0, 2, 4, 6) and (1, 3, 5, 7).
    const uint32_t even = __vminu2(best[0], best[2]);  // windows (0, 2) mod 4
    const uint32_t odd = __vminu2(best[1], best[3]);   // windows (1, 3) mod 4
    if (groups == 4) {
      col[0] = unbias<CB>(even & 0xFFFFu);
      col[static_cast<size_t>(q_count)] = unbias<CB>(odd & 0xFFFFu);
      col[2 * static_cast<size_t>(q_count)] = unbias<CB>(even >> 16);
      col[3 * static_cast<size_t>(q_count)] = unbias<CB>(odd >> 16);
    } else {
      const uint32_t e = min(even & 0xFFFFu, even >> 16);
      const uint32_t o = min(odd & 0xFFFFu, odd >> 16);
      if (groups == 2) {
        col[0] = unbias<CB>(e);
        col[static_cast<size_t>(q_count)] = unbias<CB>(o);
      } else {
        col[0] = unbias<CB>(min(e, o));
      }
    }
    return;
  }
  for (int g0 = 0; g0 < groups; g0 += 8) {
    uint32_t dead[4] = {0u, 0u, 0u, 0u};  // lanes past the block's last window
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (g0 + i >= groups) dead[(i >> 2) * 2 + (i & 1)] |= kEmpty << (16 * ((i >> 1) & 1));
    uint32_t best[4] = {~0u, ~0u, ~0u, ~0u};
    for (int k = 0; k < window; ++k) {
      const int s = k * groups + g0;
      uint32_t x[2 * CB];
      load_words<CB>(planes, s, x);
      lookup8<CB>(tab, x, one, acc);
      uint32_t mask[4] = {dead[0], dead[1], dead[2], dead[3]};
      if (!all_real) pad_lanes(pad, s, mask);
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = __vminu2(best[i], acc[i] | mask[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (g0 + i < groups) {
        const uint32_t b = best[(i >> 2) * 2 + (i & 1)];
        col[static_cast<size_t>(g0 + i) * q_count] =
            unbias<CB>(((i >> 1) & 1) ? b >> 16 : b & 0xFFFFu);
      }
    }
  }
}

template <int CB>
cudaError_t launch(const void* codes, const void* tables, void* out, int n_pad, int q_count,
                   int n, int block_n, int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_n / 8 + 1) * (2 * CB + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(flat_scan_window_perm4_kernel<CB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_pad / block_n, (q_count + kThreads - 1) / kThreads);
  flat_scan_window_perm4_kernel<CB><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<int32_t*>(out), q_count, n, block_n, window, 1u);
  return cudaGetLastError();
}

}  // namespace

// int8 tables (Q, 2*cb, 16), int32 minima (N_pad / window, Q). n: real code
// count, 0 <= n <= n_pad. Any block_n dividing n_pad that holds whole
// storage rows, any window dividing block_n.
extern "C" int qadc_flat_scan_window_regs(const void* codes, const void* tables, void* out,
                                          int n_pad, int q_count, int n, int block_n,
                                          int window, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((cb != 8 && cb != 16) || q_count < 1 || n_pad < 1 || block_n < 1 || window < 1 ||
      n_pad % block_n != 0 || block_n % window != 0 || block_n % (128 / cb) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8) return launch<8>(codes, tables, out, n_pad, q_count, n, block_n, window, s);
  return launch<16>(codes, tables, out, n_pad, q_count, n, block_n, window, s);
}
