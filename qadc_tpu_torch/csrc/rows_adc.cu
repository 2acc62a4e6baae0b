// Kernels M2 (rows_adc) and M3 (direct_scan): exact float32 ADC of 4-bit
// PQ codes stored as 128-byte rows. The two share one per-code device
// function and stay two kernels with two entry points.
//
// M2 replaces qadc_tpu/kernels/lut_scan.py:rows_adc_accumulate together with
// the selector matmul of qadc_tpu/index/ivf.py:rows_adc that reduces its
// (A, 128) lane sums to (A, cpr). Here each selected row a is named by a row
// id into the whole code storage and a pair id into the (QA, 16*CB) compact
// tables, so neither the keep-prefix bound nor the rerank materialises
// gathered copies of rows or tables, and (A, cpr) distances come out
// directly.
//
// M3 replaces qadc_tpu/kernels/lut_scan.py:rows_adc_grouped_prefetch as the
// b=1 direct path calls it (compact_out, mask_sizes, tile_min=32): every
// code of each probed partition is scored with its pair's table, codes at or
// past the partition's size hold MASK_BIG, and the minima of 32-code tiles
// are written beside the distances. The output is in code order, (QA,
// part_pad), not the Pallas kernel's c-major transposed layout.
//
// What bounds them on the H100: M3 reads each probed code once (8 bytes at
// 16x4 PQ) and writes 4 bytes of distance, so at b=1 (24 partitions, 98,304
// codes, ~1.2 MB) it is bound by launch latency and by the lookups, not by
// device memory. M2's rows are scattered (one 128-byte row per selected
// window), so it is bound by the latency of those row reads.
//
// Design: one thread per code. A code's CB bytes come in one 8- or 16-byte
// load, and neighbouring threads read neighbouring codes. M3 stages its
// pair's two compact tables in shared memory transposed to [byte][centroid],
// so a warp's 32 lookups of one byte position fall in 16 consecutive words
// and never conflict; tile minima are a warp shuffle reduction (a warp is
// one 32-code tile). M2's tables stay in device memory and are read through
// the read-only cache: each pair's 1 KB is reused by all the codes of its
// rows. Sums run in float32 in the order b = 0..CB-1, low then high nibble,
// which the plain PyTorch versions repeat.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMaskBig = 3.0e38f;  // qadc_tpu/kernels/lut_scan.py:MASK_BIG
constexpr int kThreads = 256;

template <int CB>
struct CodeBytes;
template <>
struct CodeBytes<8> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct CodeBytes<16> {
  __device__ static void load(const uint8_t* p, uint32_t* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};

// Float ADC distance of one code: sum over bytes b of lo[j_lo, b] + hi[j_hi, b],
// where lo/hi hold sub-quantizers 2b / 2b+1 at offset j * SJ + b * SB.
template <int CB, int SJ, int SB>
__device__ __forceinline__ float adc_code(const uint32_t* w, const float* lo,
                                          const float* hi) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t byte = (w[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
    acc += lo[(byte & 15u) * SJ + b * SB];
    acc += hi[(byte >> 4) * SJ + b * SB];
  }
  return acc;
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
rows_adc_kernel(const uint8_t* __restrict__ codes,   // (R, 128) all storage rows
                const int32_t* __restrict__ row_ids, // (A,)
                const int32_t* __restrict__ pair_ids,// (A,)
                const float* __restrict__ tlo,       // (QA, 16*CB), lane j*CB + b
                const float* __restrict__ thi,
                float* __restrict__ out,             // (A, cpr)
                int a_count) {
  constexpr int kCpr = 128 / CB;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(a_count) * kCpr) return;
  const int a = static_cast<int>(i / kCpr);
  const int c = static_cast<int>(i % kCpr);
  uint32_t w[CB / 4];
  CodeBytes<CB>::load(codes + static_cast<size_t>(row_ids[a]) * 128 + c * CB, w);
  const size_t t = static_cast<size_t>(pair_ids[a]) * 16 * CB;
  out[i] = adc_code<CB, CB, 1>(w, tlo + t, thi + t);
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
direct_scan_kernel(const uint8_t* __restrict__ codes,    // (P, part_pad, CB)
                   const int32_t* __restrict__ pair_part,// (QA,)
                   const float* __restrict__ tlo,        // (QA, 16*CB)
                   const float* __restrict__ thi,
                   const int32_t* __restrict__ sizes,    // (QA,) real codes
                   float* __restrict__ out,              // (QA, part_pad)
                   float* __restrict__ mins,             // (QA, part_pad / 32)
                   int part_pad) {
  __shared__ float s_lo[CB * 16];  // [b][j]
  __shared__ float s_hi[CB * 16];
  const int pair = blockIdx.x;
  const size_t t = static_cast<size_t>(pair) * 16 * CB;
  for (int i = threadIdx.x; i < 16 * CB; i += kThreads) {
    const int j = i / CB, b = i % CB;
    s_lo[b * 16 + j] = tlo[t + i];
    s_hi[b * 16 + j] = thi[t + i];
  }
  __syncthreads();
  const int code = blockIdx.y * kThreads + threadIdx.x;  // part_pad % kThreads == 0
  float d = kMaskBig;
  if (code < sizes[pair]) {
    uint32_t w[CB / 4];
    CodeBytes<CB>::load(
        codes + (static_cast<size_t>(pair_part[pair]) * part_pad + code) * CB, w);
    d = adc_code<CB, 1, 16>(w, s_lo, s_hi);
  }
  out[static_cast<size_t>(pair) * part_pad + code] = d;
  float m = d;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) mins[static_cast<size_t>(pair) * (part_pad / 32) + code / 32] = m;
}

}  // namespace

extern "C" int qadc_rows_adc(const void* codes, const void* row_ids, const void* pair_ids,
                             const void* tlo, const void* thi, void* out, int a_count,
                             int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long threads = static_cast<long long>(a_count) * (128 / cb);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* r = static_cast<const int32_t*>(row_ids);
  const auto* p = static_cast<const int32_t*>(pair_ids);
  const auto* lo = static_cast<const float*>(tlo);
  const auto* hi = static_cast<const float*>(thi);
  auto* o = static_cast<float*>(out);
  if (cb == 8)
    rows_adc_kernel<8><<<blocks, kThreads, 0, s>>>(c, r, p, lo, hi, o, a_count);
  else if (cb == 16)
    rows_adc_kernel<16><<<blocks, kThreads, 0, s>>>(c, r, p, lo, hi, o, a_count);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qadc_direct_scan(const void* codes, const void* pair_part, const void* tlo,
                                const void* thi, const void* sizes, void* out, void* mins,
                                int qa, int part_pad, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(qa, part_pad / kThreads);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* pp = static_cast<const int32_t*>(pair_part);
  const auto* lo = static_cast<const float*>(tlo);
  const auto* hi = static_cast<const float*>(thi);
  const auto* sz = static_cast<const int32_t*>(sizes);
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(mins);
  if (cb == 8)
    direct_scan_kernel<8><<<grid, kThreads, 0, s>>>(c, pp, lo, hi, sz, o, m, part_pad);
  else if (cb == 16)
    direct_scan_kernel<16><<<grid, kThreads, 0, s>>>(c, pp, lo, hi, sz, o, m, part_pad);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
