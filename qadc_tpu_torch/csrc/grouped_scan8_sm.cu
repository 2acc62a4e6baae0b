// Kernels 5 + 6, slot-minor: the grouped IVF 8-bit conventional-ADC scan to
// per-window minima and the code index of each window's minimum.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan8_grouped_tq (byte-plane
// storage) and its row128 twin lut_scan8_grouped_prefetch. Both share one
// output contract, which this kernel keeps: for every (query, probe) pair and
// every window of its partition, the minimum over the window's codes of
// sum_b T[b][code byte b], the tables in bf16 and the sums in float32 over
// b = 0..M-1, and the argmin, ties to the lowest code. The TPU kernels return
// group-local slot ids; this one returns the partition-local code index.
// Windows are the JAX contract at window = min(cpr, 8) (cpr = 128 / M codes
// per 128-byte row): a window is storage row r, in-row positions c = c0 + k *
// cs for k < window, cs = cpr / window, numbered r * cs + c0, so a partition
// has rpp * cs windows. Codes at or past the partition's size never enter a
// minimum (the port's padded-code rule); a window with no real code gets
// +inf and index -1. M 4, 8 and 16.
//
// What bounds it on the H100: shared-memory lookups and the instructions
// around them (24 M lookups at b=32's routed groups; flat_scan8_qm's rate of
// 4.9 T/s would make that 5 us). The lookup kernel it replaced took 28.3 us
// there: 9 chunks of 15 slots a group gave 9,432 blocks, ~8,400 of them with
// no live slot, and a live block's threads ran its slots one after another.
//
// Design (grouped_slot_minor.cuh): a persistent grid walks (window of 4
// slots, group, tile of 128 storage rows) items, a row a thread: it holds the
// row's 128 bytes and scans its cs scan windows (2 at M = 8). The slot
// window's tables are staged slot-minor as [M][256][4] bf16, so one 8-byte
// load fetches a code byte's entry for all 4 slots: one byte extract and
// address for 4 lookups (a 4-byte load for a window of 1 or 2 live slots).
// Lanes of a warp hold 32 rows, which may meet on a bank (lab mode
// const_code measures what that costs). Each scan window's 8
// codes are walked in code order, with 4 running minima and code indices
// and a strict < (the lower code keeps a tie); a row's cs windows of a slot
// go out in one vector store, so a warp writes 128 * cs bytes of a pair's
// row. The row is loaded before the tables are staged, so the two round
// trips overlap.
// MODE removes parts for the scan lab (kernels/scan_lab.py: GROUPED_LAB_MODES).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"  // field_offset, load_row
#include "grouped_slot_minor.cuh"

namespace {

using namespace qadc;

constexpr uint32_t kAlign = 256u * kSlots * 2u;  // one sub-quantizer's 256 entries, 4 slots

template <int M>
struct Scan8Sm {
  static constexpr int kCpr = 128 / M;
  static constexpr int kWin = 8;           // codes a window (cpr >= 8)
  static constexpr int kCs = kCpr / kWin;  // windows a storage row
  static constexpr size_t kSmem = kAlign + static_cast<size_t>(M) * 256 * kSlots * 2;
};

// A row's CS windows of one slot: CS consecutive minima and indices, one
// vector store each.
template <int CS>
__device__ __forceinline__ void store_windows(float* out_min, int32_t* out_idx,
                                              const float (&m)[CS], const int (&a)[CS]) {
  if constexpr (CS == 1) {
    out_min[0] = m[0];
    out_idx[0] = a[0];
  } else if constexpr (CS == 2) {
    *reinterpret_cast<float2*>(out_min) = make_float2(m[0], m[1]);
    *reinterpret_cast<int2*>(out_idx) = make_int2(a[0], a[1]);
  } else {
    *reinterpret_cast<float4*>(out_min) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<int4*>(out_idx) = make_int4(a[0], a[1], a[2], a[3]);
  }
}

// The 4 slots' bf16 entries at a 32-bit shared address (aligned to 8).
__device__ __forceinline__ uint2 lds_slots(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// The 2 slots' bf16 entries (slots 0 and 1) at a 32-bit shared address.
__device__ __forceinline__ uint32_t lds_slot_pair(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// The minima and code indices of a row's cs scan windows for the slot
// window's slots, PAIRS slot pairs of them (1: slots 0 and 1 only), each
// window over its codes c0 + i * cs in code order. A row with no real code
// (busy false) keeps +inf and -1.
template <int M, int MODE, int PAIRS>
__device__ __forceinline__ void scan_row(uint32_t (&w)[32], bool busy, int row, int real,
                                         uint32_t tab, uint32_t keep,
                                         float (&best)[Scan8Sm<M>::kCs][kSlots],
                                         int (&arg)[Scan8Sm<M>::kCs][kSlots]) {
  using G = Scan8Sm<M>;
#pragma unroll
  for (int c0 = 0; c0 < G::kCs; ++c0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      best[c0][s] = MODE == kQmNoMin ? 0.0f : INFINITY;
      arg[c0][s] = -1;
    }
  }
  if (!busy) return;
  if (MODE == kQmCopy) {
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) bits += __popc(w[i]);
    if (bits > 1024u) best[0][0] = 0.0f;  // never: keeps the loads
    return;
  }
  if (MODE == kQmConstCode) {
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = (w[i] & keep) | 0x5A5A5A5Au;
  }
#pragma unroll
  for (int c0 = 0; c0 < G::kCs; ++c0) {
#pragma unroll
    for (int i = 0; i < G::kWin; ++i) {
      const int c = c0 + i * G::kCs;
      float acc[kSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int b = 0; b < M; ++b) {
        const int byte_idx = c * M + b;
        const uint32_t a =
            (field_offset<3>(w[byte_idx >> 2], (byte_idx & 3) * 8, 255u) | tab) + b * kAlign;
        uint2 e;
        if (PAIRS == 1) {
          e = make_uint2(lds_slot_pair(a), 0u);
        } else {
          e = lds_slots(a);
        }
        acc[0] += __uint_as_float(e.x << 16);
        acc[1] += __uint_as_float(e.x & 0xFFFF0000u);
        if (PAIRS == 2) {
          acc[2] += __uint_as_float(e.y << 16);
          acc[3] += __uint_as_float(e.y & 0xFFFF0000u);
        }
      }
#pragma unroll
      for (int s = 0; s < 2 * PAIRS; ++s) {
        if (MODE == kQmNoMin) {
          best[c0][s] += acc[s];
        } else if (c < real && acc[s] < best[c0][s]) {  // strict: the lower code keeps a tie
          best[c0][s] = acc[s];
          arg[c0][s] = row * G::kCpr + c;
        }
      }
    }
  }
}

template <int M, int MODE>
__global__ void __launch_bounds__(kSmThreads)
grouped_scan8_sm_kernel(const uint8_t* __restrict__ codes,        // (P, rpp, 128)
                        const uint16_t* __restrict__ tables,      // (QA, M, 256) bf16
                        const int32_t* __restrict__ group_part,   // (gcap,)
                        const int32_t* __restrict__ slot_pair,    // (gcap, G), -1 = empty
                        const int32_t* __restrict__ group_sizes,  // (gcap,) real codes
                        float* __restrict__ out_min,              // (QA, rpp * cs)
                        int32_t* __restrict__ out_idx,            // (QA, rpp * cs)
                        int gcap, int group_size, int rpp, uint32_t keep) {
  using G = Scan8Sm<M>;
  constexpr int kVecs = M * 256 / 8;  // 16-byte vectors of one pair's table
  __shared__ ItemBatch batch;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t tab = (base + kAlign - 1) & ~(kAlign - 1);
  uint2* s_tab = reinterpret_cast<uint2*>(smem + (tab - base));  // [M*256] x 4 slots

  const int windows = rpp * G::kCs;
  const int tiles = (rpp + kSmTile - 1) / kSmTile;
  const long long items = item_count(gcap, group_size, tiles);
  for (long long item0 = blockIdx.x; item0 < items;
       item0 += static_cast<long long>(gridDim.x) * kBatch) {
    check_items(slot_pair, group_part, group_sizes, group_size, item0, items, gcap, tiles, batch);
    for (int k = 0; k < batch.count; ++k) {  // uniform across the block
      const int row = batch.tile[k] * kSmTile + threadIdx.x;
      const int real = batch.size[k] - row * G::kCpr;  // real codes in this row
      const bool busy = row < rpp && real > 0;
      uint32_t w[32];
      if (busy) load_row(codes + (static_cast<size_t>(batch.part[k]) * rpp + row) * 128, w);
      const int n = batch.n[k];
      const int32_t* ids = batch.ids[k];
      __syncthreads();  // the last item is done with s_tab
      // Entry e of the 4 slots as one 8-byte vector: thread i takes a vector
      // (8 entries) of each slot's table and writes those entries' vectors.
      for (int vec = threadIdx.x; vec < kVecs; vec += kSmThreads) {
        uint4 v[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          v[s] = s < n ? reinterpret_cast<const uint4*>(tables)[
                             static_cast<size_t>(ids[s]) * kVecs + vec]
                       : make_uint4(0, 0, 0, 0);
        const uint32_t x[kSlots][4] = {{v[0].x, v[0].y, v[0].z, v[0].w},
                                       {v[1].x, v[1].y, v[1].z, v[1].w},
                                       {v[2].x, v[2].y, v[2].z, v[2].w},
                                       {v[3].x, v[3].y, v[3].z, v[3].w}};
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // entry j of the vector: half j % 2 of word j / 2
          const uint32_t sel = j % 2 ? 0x7632u : 0x5410u;
          s_tab[8 * vec + j] = make_uint2(__byte_perm(x[0][j / 2], x[1][j / 2], sel),
                                          __byte_perm(x[2][j / 2], x[3][j / 2], sel));
        }
      }
      __syncthreads();
      if (row >= rpp) continue;
      float best[G::kCs][kSlots];
      int arg[G::kCs][kSlots];
      if (n <= 2) {
        scan_row<M, MODE, 1>(w, busy, row, real, tab, keep, best, arg);  // slots 0, 1: 4-byte loads
      } else {
        scan_row<M, MODE, 2>(w, busy, row, real, tab, keep, best, arg);
      }
      // The row's cs windows of each live slot, one vector store each.
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (s < n) {
          const size_t o =
              static_cast<size_t>(ids[s]) * windows + static_cast<size_t>(row) * G::kCs;
          float m[G::kCs];
          int a[G::kCs];
#pragma unroll
          for (int c0 = 0; c0 < G::kCs; ++c0) {
            m[c0] = best[c0][s];
            a[c0] = arg[c0][s];
          }
          store_windows<G::kCs>(out_min + o, out_idx + o, m, a);
        }
      }
    }
  }
}

template <int M, int MODE>
cudaError_t launch(const void* codes, const void* tables, const void* group_part,
                   const void* slot_pair, const void* group_sizes, void* out_min, void* out_idx,
                   int gcap, int group_size, int rpp, cudaStream_t stream) {
  using G = Scan8Sm<M>;
  auto kernel = grouped_scan8_sm_kernel<M, MODE>;
  const long long items = item_count(gcap, group_size, (rpp + kSmTile - 1) / kSmTile);
  kernel<<<persistent_blocks(kernel, G::kSmem, items), kSmThreads, G::kSmem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint16_t*>(tables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(out_min),
      static_cast<int32_t*>(out_idx), gcap, group_size, rpp,
      0u);  // lab mode const_code: every code byte 0x5A, the loads kept
  return cudaGetLastError();
}

}  // namespace

// codes (P, rpp, 128), tables (QA, m, 256) bf16, group_part / group_sizes
// (gcap,), slot_pair (gcap, group_size), out_min / out_idx (QA, rpp * cs).
extern "C" int qadc_grouped_scan8_sm(const void* codes, const void* tables,
                                     const void* group_part, const void* slot_pair,
                                     const void* group_sizes, void* out_min, void* out_idx,
                                     int gcap, int group_size, int rpp, int m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 4)
    return launch<4, kQmFull>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                              out_idx, gcap, group_size, rpp, s);
  if (m == 8)
    return launch<8, kQmFull>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                              out_idx, gcap, group_size, rpp, s);
  if (m == 16)
    return launch<16, kQmFull>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                               out_idx, gcap, group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scan lab: the kernel at m 8 (8x8 PQ) with parts removed (mode: a
// qadc::QmMode, 1 copy, 2 no_min, 3 const_code). Only copy's output (+inf and
// -1 everywhere) is defined.
extern "C" int qadc_grouped_scan8_sm_lab(const void* codes, const void* tables,
                                         const void* group_part, const void* slot_pair,
                                         const void* group_sizes, void* out_min, void* out_idx,
                                         int gcap, int group_size, int rpp, int mode,
                                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch<8, kQmCopy>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                out_idx, gcap, group_size, rpp, s);
    case kQmNoMin:
      return launch<8, kQmNoMin>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                 out_idx, gcap, group_size, rpp, s);
    case kQmConstCode:
      return launch<8, kQmConstCode>(codes, tables, group_part, slot_pair, group_sizes, out_min,
                                     out_idx, gcap, group_size, rpp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
