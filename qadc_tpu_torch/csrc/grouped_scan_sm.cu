// Kernel M1 with float32 tables, slot-minor: the grouped IVF 4-bit
// conventional-ADC scan to per-row window minima.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_grouped_tq (byte-plane
// storage) and its row128 twin lut_scan_grouped_prefetch with
// acc_dtype_name="float32", as qadc_tpu/index/ivf.py's 4-bit search_adc calls
// them. The contract: out[pair, row] is the minimum over the storage row's
// real codes (those below the group's size) of the float32 sum of the pair's
// table entries in adc4_sum.cuh's order (rows_adc's: b = 0..CB-1, low nibble
// then high), so a minimum is the rerank's distance bit for bit; +inf for
// rows at or past ceil(size / cpr). CB 8 and 16 (16x4 and 32x4 PQ).
//
// What bounds it on the H100: shared-memory lookups, 32 four-byte entries a
// clock an SM (48 M lookups at b=32's routed groups: 6.5 us at best). The
// lookup kernel it replaced took 36.6 us there: two-thirds of its (group, row
// tile, chunk of 43 slots) blocks had no live slot, and a live block's
// threads ran its slots one after another, the blocks of the busiest groups
// last.
//
// Design (grouped_slot_minor.cuh): a persistent grid walks (window of 4
// slots, group, tile of 128 rows) items, a row a thread; the window's tables
// are staged slot-minor, as two slot pairs [2][2*CB*16][2] float32, so two
// 8-byte loads (adc4_sum_slot_pairs) fetch a code's entry for all 4 slots:
// one nibble extract and address for 4 lookups (one load for a window of 1
// or 2 live slots), and no bank conflict whatever the 32 rows' nibbles.
// (Staged as [2*CB*16][4], one 16-byte load a lookup, the rows' entries met
// on banks: lab mode quad, 0.030 ms against 0.018 at adc4 b=32's groups on
// an H100, scripts/torch_scan_lab.py.)
// Each thread keeps its 4 running minima with a strict < and writes its row
// of each live slot: a warp writes 128 bytes of a pair's row. The row's codes
// are loaded before the tables are staged, so the two round trips overlap.
// MODE removes parts for the scan lab (kernels/scan_lab.py: GROUPED_LAB_MODES),
// or (kQuad) stages the tables as [2*CB*16][4].

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "adc4_sum.cuh"
#include "grouped_slot_minor.cuh"

namespace {

using namespace qadc;

constexpr int kQuad = 4;  // lab mode: the tables as [2*CB*16][4], a 16-byte load a lookup
constexpr uint32_t kAlign = 16u * kSlots * 4u;  // one sub-quantizer's 16 entries, 4 slots

template <int CB>
constexpr size_t smem_bytes() {
  return kAlign + 2 * CB * 16 * kSlots * 4;
}

// The running minima of a row's real codes for the window's slots, PAIRS
// slot pairs of them (1: slots 0 and 1 only).
template <int CB, int MODE, int PAIRS>
__device__ __forceinline__ void scan_row(uint32_t (&w)[32], int real, uint32_t tab, uint32_t keep,
                                         float (&best)[kSlots]) {
  constexpr int kCpr = 128 / CB;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) best[s] = MODE == kQmNoMin ? 0.0f : INFINITY;
  if (MODE == kQmCopy) {
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) bits += __popc(w[i]);
    if (bits > 1024u) best[0] = 0.0f;  // never: keeps the loads
    return;
  }
  if (MODE == kQmConstCode) {
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = (w[i] & keep) | 0x5A5A5A5Au;
  }
#pragma unroll
  for (int c = 0; c < kCpr; ++c) {
    float acc[kSlots];
    if (MODE == kQuad) {
      adc4_sum_minor<CB, kSlots, 4>(w, c, tab, acc);  // an entry: 4 slots, 16 bytes
    } else {
      adc4_sum_slot_pairs<CB, PAIRS>(w, c, tab, acc);
    }
#pragma unroll
    for (int s = 0; s < 2 * PAIRS; ++s) {
      if (MODE == kQmNoMin) {
        best[s] += acc[s];
      } else if (c < real && acc[s] < best[s]) {
        best[s] = acc[s];
      }
    }
  }
}

template <int CB, int MODE>
__global__ void __launch_bounds__(kSmThreads)
grouped_scan_sm_kernel(const uint8_t* __restrict__ codes,        // (P, rpp, 128)
                       const float* __restrict__ tables,         // (QA, 2*CB, 16)
                       const int32_t* __restrict__ group_part,   // (gcap,)
                       const int32_t* __restrict__ slot_pair,    // (gcap, G), -1 = empty
                       const int32_t* __restrict__ group_sizes,  // (gcap,) real codes
                       float* __restrict__ out,                  // (QA, rpp)
                       int gcap, int group_size, int rpp, uint32_t keep) {
  constexpr int kVecs = 2 * CB * 16 / 4;  // 16-byte vectors of one pair's table
  constexpr int kCpr = 128 / CB;
  __shared__ ItemBatch batch;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t tab = (base + kAlign - 1) & ~(kAlign - 1);
  float4* s_quad = reinterpret_cast<float4*>(smem + (tab - base));  // kQuad: [2*CB*16] x 4 slots
  float2* s_pairs = reinterpret_cast<float2*>(smem + (tab - base));  // [2][2*CB*16] x 2 slots

  const int tiles = (rpp + kSmTile - 1) / kSmTile;
  const long long items = item_count(gcap, group_size, tiles);
  for (long long item0 = blockIdx.x; item0 < items;
       item0 += static_cast<long long>(gridDim.x) * kBatch) {
    check_items(slot_pair, group_part, group_sizes, group_size, item0, items, gcap, tiles, batch);
    for (int k = 0; k < batch.count; ++k) {  // uniform across the block
      const int row = batch.tile[k] * kSmTile + threadIdx.x;
      const int real = batch.size[k] - row * kCpr;  // real codes in this row
      const bool busy = row < rpp && real > 0;
      uint32_t w[32];
      if (busy) load_row(codes + (static_cast<size_t>(batch.part[k]) * rpp + row) * 128, w);
      const int n = batch.n[k];
      const int32_t* ids = batch.ids[k];
      __syncthreads();  // the last item is done with s_tab
      // Thread i takes a vector (4 entries) of each slot's table and writes
      // those entries' slot pairs (or, kQuad, their 4 slots as one vector).
      for (int vec = threadIdx.x; vec < kVecs; vec += kSmThreads) {
        float4 v[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          v[s] = s < n ? reinterpret_cast<const float4*>(tables)[
                             static_cast<size_t>(ids[s]) * kVecs + vec]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float e[kSlots][4] = {{v[0].x, v[0].y, v[0].z, v[0].w},
                                    {v[1].x, v[1].y, v[1].z, v[1].w},
                                    {v[2].x, v[2].y, v[2].z, v[2].w},
                                    {v[3].x, v[3].y, v[3].z, v[3].w}};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (MODE == kQuad) {
            s_quad[4 * vec + j] = make_float4(e[0][j], e[1][j], e[2][j], e[3][j]);
          } else {
            s_pairs[4 * vec + j] = make_float2(e[0][j], e[1][j]);
            s_pairs[kVecs * 4 + 4 * vec + j] = make_float2(e[2][j], e[3][j]);
          }
        }
      }
      __syncthreads();
      if (!busy) {
        if (row < rpp) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (s < n) out[static_cast<size_t>(ids[s]) * rpp + row] = INFINITY;
        }
        continue;
      }
      float best[kSlots];
      if (n <= 2) {
        scan_row<CB, MODE, 1>(w, real, tab, keep, best);  // one slot pair: half the loads
      } else {
        scan_row<CB, MODE, 2>(w, real, tab, keep, best);
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (s < n) out[static_cast<size_t>(ids[s]) * rpp + row] = best[s];
    }
  }
}

template <int CB, int MODE>
cudaError_t launch(const void* codes, const void* tables, const void* group_part,
                   const void* slot_pair, const void* group_sizes, void* out, int gcap,
                   int group_size, int rpp, cudaStream_t stream) {
  auto kernel = grouped_scan_sm_kernel<CB, MODE>;
  constexpr size_t smem = smem_bytes<CB>();
  const long long items = item_count(gcap, group_size, (rpp + kSmTile - 1) / kSmTile);
  kernel<<<persistent_blocks(kernel, smem, items), kSmThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(tables),
      static_cast<const int32_t*>(group_part), static_cast<const int32_t*>(slot_pair),
      static_cast<const int32_t*>(group_sizes), static_cast<float*>(out), gcap, group_size, rpp,
      0u);  // lab mode const_code: every code byte 0x5A, the loads kept
  return cudaGetLastError();
}

}  // namespace

// codes (P, rpp, 128), tables (QA, 2*cb, 16) float32, group_part / group_sizes
// (gcap,), slot_pair (gcap, group_size), out (QA, rpp) float32.
extern "C" int qadc_grouped_scan_sm(const void* codes, const void* tables,
                                    const void* group_part, const void* slot_pair,
                                    const void* group_sizes, void* out, int gcap,
                                    int group_size, int rpp, int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8)
    return launch<8, kQmFull>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                              group_size, rpp, s);
  if (cb == 16)
    return launch<16, kQmFull>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                               group_size, rpp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scan lab: the kernel at cb 8 (16x4 PQ) with parts removed (mode: a
// qadc::QmMode, 1 copy, 2 no_min, 3 const_code) or with the tables as
// [2*CB*16][4] (mode 4, quad). Only copy's output (+inf for every live pair's
// row) and quad's (the scan's minima) are defined.
extern "C" int qadc_grouped_scan_sm_lab(const void* codes, const void* tables,
                                        const void* group_part, const void* slot_pair,
                                        const void* group_sizes, void* out, int gcap,
                                        int group_size, int rpp, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kQmCopy:
      return launch<8, kQmCopy>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                                group_size, rpp, s);
    case kQmNoMin:
      return launch<8, kQmNoMin>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                                 group_size, rpp, s);
    case kQmConstCode:
      return launch<8, kQmConstCode>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                                     group_size, rpp, s);
    case kQuad:
      return launch<8, kQuad>(codes, tables, group_part, slot_pair, group_sizes, out, gcap,
                              group_size, rpp, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
