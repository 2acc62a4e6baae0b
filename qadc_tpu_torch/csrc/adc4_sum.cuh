// The 4-bit ADC sum of one code, shared by the float 4-bit scans
// (grouped_scan_sm.cu, flat_scan.cu, flat_scan_window.cu, flat_scan_qm.cuh,
// flat_scan_window_qm.cu) so that the float sum order has a single
// definition: over code bytes b = 0..CB-1, the even sub-quantizer's entry
// (low nibble), then the odd one's (high nibble). That is rows_adc's order
// (rows_adc.cu), so a float minimum of a scan is bit for bit the rerank's
// distance of its code.
//
// Tables are laid out [2*CB][16] (sub-quantizer, centroid), float32 summed
// in float32 (conventional ADC).

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace qadc {

// Loads one 128-byte storage row into 32 words (eight 16-byte loads).
__device__ __forceinline__ void load_row(const uint8_t* row, uint32_t (&w)[32]) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 v = src[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

// Distance of code c (< 128 / CB) of a row held in w against table t. Call
// it with a compile-time c (an unrolled loop) so that w stays in registers.
template <int CB>
__device__ __forceinline__ float adc4_sum(const uint32_t (&w)[32], int c, const float* t) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const int byte_idx = c * CB + b;
    const uint32_t byte = (w[byte_idx >> 2] >> ((byte_idx & 3) * 8)) & 0xFFu;
    acc += t[(2 * b) * 16 + (byte & 15u)];      // even sub-quantizer: low nibble
    acc += t[(2 * b + 1) * 16 + (byte >> 4)];   // odd sub-quantizer: high nibble
  }
  return acc;
}

// The same sum, in the same order, of one code held alone in CB / 4 words
// (flat_scan_window.cu reads codes from shared memory, one at a time).
template <int CB>
__device__ __forceinline__ float adc4_code_sum(const uint32_t (&cw)[CB / 4], const float* t) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t byte = (cw[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
    acc += t[(2 * b) * 16 + (byte & 15u)];      // even sub-quantizer: low nibble
    acc += t[(2 * b + 1) * 16 + (byte >> 4)];   // odd sub-quantizer: high nibble
  }
  return acc;
}

// ---- the query-minor variant: a code is warp-uniform, a lane is QPL queries ----
//
// Tables lie in shared memory as [2*CB][16][32 * QPL] float32 (sub-quantizer,
// centroid, query), at a shared address aligned to 16 entries' bytes, so an
// entry's offset can be OR-ed into a lane's address. lane_addr is that base
// plus the lane's QPL * 4 * lane bytes: the 32 lanes of a warp read one
// entry's 32 * QPL consecutive floats, whatever the code byte, with no bank
// conflict. The sum runs in adc4_sum's order for every query.

// ((word >> bit) & mask) << S as one shift and one mask; bit and S are
// compile-time after unrolling.
template <int S>
__device__ __forceinline__ uint32_t field_offset(uint32_t word, int bit, uint32_t mask) {
  return (bit >= S ? word >> (bit >= S ? bit - S : 0) : word << (bit < S ? S - bit : 0))
         & (mask << S);
}

// QPL consecutive float32 from a 32-bit shared address (aligned to QPL * 4).
template <int QPL>
struct LdsF32;
template <>
struct LdsF32<1> {
  static __device__ __forceinline__ void load(uint32_t a, float (&v)[1]) {
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(a));
  }
};
template <>
struct LdsF32<2> {
  static __device__ __forceinline__ void load(uint32_t a, float (&v)[2]) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v[0]), "=f"(v[1]) : "r"(a));
  }
};
template <>
struct LdsF32<4> {
  static __device__ __forceinline__ void load(uint32_t a, float (&v)[4]) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(a));
  }
};

// Distances of code c (< 128 / CB) of the row held in w for the lane's QPL
// tables, where one entry of the minor-axis layout [2*CB][16][minor] spans
// 1 << SHIFT bytes (SHIFT: log2 of the minor axis' float32 bytes) and the
// table lies at a shared address aligned to 16 << SHIFT, lane_addr being that
// base plus the lane's own bytes (< 1 << SHIFT). Used by the query-minor flat
// scan (a lane is QPL queries) and the grouped scan lab's slot-minor variant
// (grouped_scan_sm.cu). Call it with a compile-time c, as adc4_sum.
template <int CB, int QPL, int SHIFT>
__device__ __forceinline__ void adc4_sum_minor(const uint32_t (&w)[32], int c,
                                               uint32_t lane_addr, float (&acc)[QPL]) {
  constexpr uint32_t kSubq = 16u << SHIFT;  // bytes of one sub-quantizer's 16 entries
#pragma unroll
  for (int i = 0; i < QPL; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const int byte_idx = c * CB + b;
    const uint32_t word = w[byte_idx >> 2];
    const int bit = (byte_idx & 3) * 8;
    float lo[QPL], hi[QPL];
    LdsF32<QPL>::load((field_offset<SHIFT>(word, bit, 15u) | lane_addr) + (2 * b) * kSubq, lo);
    LdsF32<QPL>::load((field_offset<SHIFT>(word, bit + 4, 15u) | lane_addr) + (2 * b + 1) * kSubq,
                      hi);
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      acc[i] += lo[i];  // even sub-quantizer: low nibble
      acc[i] += hi[i];  // odd sub-quantizer: high nibble
    }
  }
}

// The same sum of one code held alone in CB / 4 words (the query-minor window
// scan, flat_scan_window_qm.cu, reads one code a window rank).
template <int CB, int QPL, int SHIFT>
__device__ __forceinline__ void adc4_code_sum_minor(const uint32_t (&cw)[CB / 4],
                                                    uint32_t lane_addr, float (&acc)[QPL]) {
  constexpr uint32_t kSubq = 16u << SHIFT;
#pragma unroll
  for (int i = 0; i < QPL; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t word = cw[b >> 2];
    const int bit = (b & 3) * 8;
    float lo[QPL], hi[QPL];
    LdsF32<QPL>::load((field_offset<SHIFT>(word, bit, 15u) | lane_addr) + (2 * b) * kSubq, lo);
    LdsF32<QPL>::load((field_offset<SHIFT>(word, bit + 4, 15u) | lane_addr) + (2 * b + 1) * kSubq,
                      hi);
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      acc[i] += lo[i];  // even sub-quantizer: low nibble
      acc[i] += hi[i];  // odd sub-quantizer: high nibble
    }
  }
}

// The same sum for up to 4 slots at once, their tables in shared memory as
// [2][2*CB][16][2] float32 (slot pair, sub-quantizer, centroid, slot of the
// pair) at a 32-bit address `tab` aligned to 128 bytes. A lookup is an
// 8-byte load a slot pair (PAIRS of them: 1 sums slots 0 and 1 only, and
// leaves acc[2], acc[3] at 0), and the 16 entries of one slot pair's
// sub-quantizer fill 128 bytes: the 16 lanes that one 8-byte load serves at a
// time hit distinct banks whatever their nibbles (grouped_scan_sm.cu: a lane
// is a storage row). Call it with a compile-time c, as adc4_sum.
template <int CB, int PAIRS>
__device__ __forceinline__ void adc4_sum_slot_pairs(const uint32_t (&w)[32], int c, uint32_t tab,
                                                    float (&acc)[4]) {
  constexpr uint32_t kSubq = 16u * 8u;            // bytes of a slot pair's sub-quantizer
  constexpr uint32_t kPair = 2u * CB * kSubq;     // bytes of a slot pair's tables
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const int byte_idx = c * CB + b;
    const uint32_t word = w[byte_idx >> 2];
    const int bit = (byte_idx & 3) * 8;
    const uint32_t lo = (field_offset<3>(word, bit, 15u) | tab) + (2 * b) * kSubq;
    const uint32_t hi = (field_offset<3>(word, bit + 4, 15u) | tab) + (2 * b + 1) * kSubq;
    float l[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      float lp[2], hp[2];
      LdsF32<2>::load(lo + p * kPair, lp);
      LdsF32<2>::load(hi + p * kPair, hp);
      l[2 * p] = lp[0];
      l[2 * p + 1] = lp[1];
      h[2 * p] = hp[0];
      h[2 * p + 1] = hp[1];
    }
#pragma unroll
    for (int i = 0; i < 2 * PAIRS; ++i) {
      acc[i] += l[i];  // even sub-quantizer: low nibble
      acc[i] += h[i];  // odd sub-quantizer: high nibble
    }
  }
}

// log2 of the bytes of one entry's chunk of 32 * QPL float32 queries.
template <int QPL>
constexpr int kQueryMinorShift = QPL == 1 ? 7 : QPL == 2 ? 8 : 9;

// The query-minor flat scan's sum: the minor axis is a chunk of 32 * QPL queries.
template <int CB, int QPL>
__device__ __forceinline__ void adc4_sum_query_minor(const uint32_t (&w)[32], int c,
                                                     uint32_t lane_addr, float (&acc)[QPL]) {
  adc4_sum_minor<CB, QPL, kQueryMinorShift<QPL>>(w, c, lane_addr, acc);
}

}  // namespace qadc
