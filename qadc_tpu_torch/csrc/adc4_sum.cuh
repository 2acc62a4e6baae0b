// The 4-bit ADC sum of one code, shared by the 4-bit scans (grouped_scan.cu,
// flat_scan.cu, flat_scan_window.cu) so that the float sum order has a single definition: over
// code bytes b = 0..CB-1, the even sub-quantizer's entry (low nibble), then
// the odd one's (high nibble). That is rows_adc's order (rows_adc.cu), so a
// float minimum of a scan is bit for bit the rerank's distance of its code.
//
// Tables are laid out [2*CB][16] (sub-quantizer, centroid), int8 entries in
// [0, 127] summed in int32 with no 127 saturation (Quick ADC), or float32
// summed in float32 (conventional ADC).

#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace qadc {

template <typename T>
struct Acc;
template <>
struct Acc<int8_t> {  // Quick ADC: int32 sums of int8 entries
  using type = int32_t;
  static __device__ int32_t none() { return INT_MAX; }
  static __device__ int32_t trim() { return 1 << 30; }  // lut_scan.TRIM_SENTINEL
};
template <>
struct Acc<float> {  // conventional ADC: float32 sums
  using type = float;
  static __device__ float none() { return INFINITY; }
  static __device__ float trim() { return INFINITY; }
};

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
template <int CB, typename T>
__device__ __forceinline__ typename Acc<T>::type adc4_sum(const uint32_t (&w)[32], int c,
                                                          const T* t) {
  typename Acc<T>::type acc = 0;
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
template <int CB, typename T>
__device__ __forceinline__ typename Acc<T>::type adc4_code_sum(const uint32_t (&cw)[CB / 4],
                                                               const T* t) {
  typename Acc<T>::type acc = 0;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t byte = (cw[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
    acc += t[(2 * b) * 16 + (byte & 15u)];      // even sub-quantizer: low nibble
    acc += t[(2 * b + 1) * 16 + (byte >> 4)];   // odd sub-quantizer: high nibble
  }
  return acc;
}

}  // namespace qadc
