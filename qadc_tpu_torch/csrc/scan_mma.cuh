// The 4-bit int8 scan as a tensor-core product: the flat Quick ADC scan's
// (scan_mma.cu) and the scan lab's (scan_lab.cu). M1 (scan_mma.cu) takes
// its primitives (mma_s8, cp.async, resident_blocks) and turns the product
// around: codes on M, pairs on N.
//
// The scan is  min over a storage row of  (tables x one-hot(codes)):  a
// query's 2*CB tables of 16 int8 entries are one row of 32*CB bytes, a code
// selects one entry of each table, and the int32 sum of the selected entries
// is the dot product of that row with the code's 0/1 one-hot column. int8
// entries times 0/1 summed in int32 are exact in any order, so the product
// gives the sums of the looked-up entries bit for bit.
//
// The product: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, A = tables
// (16 queries x 32 k), B = one-hot (32 k x 8 codes), C = sums (16 x 8).
// One k-step is one code byte b: k 0..15 is table 2b (low nibble), k 16..31
// table 2b+1 (high nibble), so a (2*CB, 16) int8 table is the row-major A
// operand as it stands. Lane (g = lane >> 2, t = lane & 3) holds
//   A: rows g and g + 8, the words at byte offsets 32b + 4t and 32b + 16 + 4t;
//   B: column g (a code), k rows 4t..4t+3 (b0) and 16 + 4t.. (b1);
//   C: rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1.
// A warp keeps the A fragments of its 16*MT table rows in registers for the
// whole kernel (4*CB registers an m-tile); the inner loop holds no lookup.
//
// The B fragment is built in registers from the code byte. With x =
// (nibble << 3) ^ (t << 5), x is 8 * (nibble & 3) when nibble >> 2 == t and
// at least 32 otherwise, and PTX's shl.b32 clamps a shift of 32 or more to
// zero: b = shl(1, x) is the lane's word of the one-hot column. The xor runs
// on a whole word of four code bytes at once, which leaves a byte extract
// and a shift per nibble.
//
// Storage rows: a lane reads the 16 bytes at offset 16g of a 128-byte row.
// At CB = 16 they are code g, one 8-code tile a row; at CB = 8 they are
// codes 2g (tile 0) and 2g + 1 (tile 1), two tiles a row. A row's minimum is
// min(c0, c1) over its tiles, then two xor-shuffles over t. Codes at or past
// the row's real count take INT_MAX before the minimum (the padded-code
// rule). With kRows the minimum is taken over (sum << 4) | code_in_row
// (sums are at most 32 * 127 = 4064 and a row holds at most 16 codes), so
// the packed minimum carries the lowest tied code.
//
// A warp walks octs of eight consecutive rows, copied into its own ring in
// shared memory two octs ahead (cp.async, no registers held meanwhile);
// lane t keeps rows 8*oct + 2t and + 2t + 1, so each (table row, oct) is
// stored as one 32-byte sector.
//
// The lab's modes are compile-time subsets of {expand, mma, min} (kFull in
// production). A removed part is replaced by the cheapest value that still
// depends on what is kept, so the compiler cannot drop the rest.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace qadc {

constexpr int kScanTrim = 1 << 30;  // lut_scan.TRIM_SENTINEL
constexpr int kMmaThreads = 256;    // 8 warps a block
constexpr int kMmaWarps = kMmaThreads / 32;

// Lab mode bits: the parts of the scan a kernel keeps.
constexpr int kExpand = 1;  // build the one-hot from the codes
constexpr int kMma = 2;     // the tensor-core product
constexpr int kMin = 4;     // the row minimum (masks, shuffles)
constexpr int kFull = kExpand | kMma | kMin;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x << s, zero for s >= 32 (PTX clamps the shift; C++ leaves it undefined).
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// The A fragments of table rows idx[j][h] (m-tile j, C row g + 8h; -1: none,
// zeros) of `tables`, rows of 32*CB bytes.
template <int CB, int MT>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][CB][4], int nt,
                                       const int8_t* __restrict__ tables,
                                       const int (&idx)[MT][2], int t) {
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = j < nt && idx[j][h] >= 0;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          tables + static_cast<size_t>(live ? idx[j][h] : 0) * (32 * CB));
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        a[j][b][h] = live ? __ldg(p + 8 * b + t) : 0u;          // k 4t..4t+3
        a[j][b][2 + h] = live ? __ldg(p + 8 * b + 4 + t) : 0u;  // k 16+4t..
      }
    }
  }
}

// One storage row: v[j][h] = the row's minimum for table row (j, h), over
// its first `real` codes (real >= 1; kRows: packed with the code's position).
template <int CB, int MT, int MODE, bool kRows>
__device__ __forceinline__ void scan_row(const uint32_t (&a)[MT][CB][4], int nt, const uint4& cw,
                                         int real, int t, uint32_t tsel, uint32_t lab,
                                         int (&v)[MT][2]) {
  constexpr int kCpr = 128 / CB;
  constexpr int kTiles = kCpr / 8;  // 8-code tiles of a row
  constexpr int kWords = CB / 4;    // words of one code
  const uint32_t w[4] = {cw.x, cw.y, cw.z, cw.w};
  int c[kTiles][MT][4];
  uint32_t seen[kTiles];  // without kMma: what the product would have read
#pragma unroll
  for (int tile = 0; tile < kTiles; ++tile) {
    seen[tile] = 0u;
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[tile][j][i] = 0;
  }
  // Without kExpand: nibble 4 * tile everywhere (a one-hot that differs by
  // tile and, through lab, by row, so no two products are the same).
  uint32_t bconst[kTiles];
#pragma unroll
  for (int tile = 0; tile < kTiles; ++tile) bconst[tile] = (t == tile ? 1u : 0u) | lab;

#pragma unroll
  for (int wi = 0; wi < kWords; ++wi) {
    uint32_t wl[kTiles], wh[kTiles];
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
      const uint32_t word = w[tile * kWords + wi];
      wl[tile] = ((word << 3) & 0x78787878u) ^ tsel;
      wh[tile] = ((word >> 1) & 0x78787878u) ^ tsel;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = wi * 4 + i;  // code byte: the k-step
      uint32_t b0[kTiles], b1[kTiles];
#pragma unroll
      for (int tile = 0; tile < kTiles; ++tile) {
        b0[tile] = b1[tile] = bconst[tile];
        if constexpr ((MODE & kExpand) != 0) {
          b0[tile] = shl_clamp(1u, __byte_perm(wl[tile], 0u, 0x4440u | i));
          b1[tile] = shl_clamp(1u, __byte_perm(wh[tile], 0u, 0x4440u | i));
        }
        if constexpr ((MODE & kMma) == 0) seen[tile] |= b0[tile] | b1[tile];
      }
      if constexpr ((MODE & kMma) != 0) {
        // Both tiles of an m-tile back to back: they read the same A registers.
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int tile = 0; tile < kTiles; ++tile)
            if (j < nt) mma_s8(c[tile][j], a[j][b], b0[tile], b1[tile]);
      }
    }
  }
  if constexpr ((MODE & kMma) == 0) {
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c[tile][j][i] =
              static_cast<int>(seen[tile] ^ (0x9E3779B1u * ((tile * MT + j) * 4 + i + 1)));
  }

#pragma unroll
  for (int j = 0; j < MT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m;
      if constexpr ((MODE & kMin) != 0) {
        m = INT_MAX;
#pragma unroll
        for (int tile = 0; tile < kTiles; ++tile)
#pragma unroll
          for (int ci = 0; ci < 2; ++ci) {
            // Column 2t + ci of the tile: its code's position in the row.
            const int code = CB == 8 ? 2 * (2 * t + ci) + tile : 2 * t + ci;
            int x = c[tile][j][2 * h + ci];
            if constexpr (kRows) x = (x << 4) | code;
            if (real < kCpr && code >= real) x = INT_MAX;  // a padded code
            m = min(m, x);
          }
        m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 1));
        m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 2));
      } else {
        m = 0;
#pragma unroll
        for (int tile = 0; tile < kTiles; ++tile) m ^= c[tile][j][2 * h] ^ c[tile][j][2 * h + 1];
      }
      v[j][h] = m;
    }
  }
}

// 16 bytes from global to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int kOct = 8;     // storage rows a warp takes at a time
constexpr int kStages = 3;  // octs of codes a warp keeps in flight or in use
using CodeRing = uint4[kStages][kOct * 8];  // one warp's ring: 1 KB octs

// What a row's kept value x writes: (minimum, code index).
template <int CB, bool kRows>
__device__ __forceinline__ int2 row_result(int x, int row) {
  if (x == INT_MAX) return make_int2(kScanTrim, -1);  // no real code
  if constexpr (kRows) return make_int2(x >> 4, row * (128 / CB) + (x & 15));
  return make_int2(x, 0);
}

// A warp's share of one scan: octs oct0, oct0 + oct_step, .. (eight rows
// each) of the r_count storage rows at `codes`, of which the first n_real
// codes are real. The warp copies its octs into `ring` kStages - 1 ahead
// (cp.async: lane i brings the i-th and (32 + i)-th 16 bytes of an oct) and
// reads each row back as one vector a lane. Rows run in pairs; lane t keeps
// rows 2t and 2t + 1 of the oct, so the four lanes of a group store one
// whole 32-byte sector per table row (with half sectors, 16 bytes a lane
// group, the lab's copy mode took 0.047 ms for 32 MB of minima on an H100;
// with whole sectors 0.015). Table row (j, h) writes
// out[idx[j][h] * r_count + row] (idx -1: nothing): the row's minimum,
// kScanTrim for a row with no real code; with kRows also rows_out: the code's
// index (row * cpr + position), -1 for such a row.
template <int CB, int MT, int MODE, bool kRows>
__device__ __forceinline__ void scan_rows(const uint32_t (&a)[MT][CB][4], int nt,
                                          const uint8_t* __restrict__ codes, int r_count,
                                          int n_real, int oct0, int oct_step,
                                          const int (&idx)[MT][2], int32_t* __restrict__ out,
                                          int32_t* __restrict__ rows_out, int zero,
                                          CodeRing& ring) {
  constexpr int kCpr = 128 / CB;
  constexpr bool kReadsCodes = (MODE & kExpand) != 0 || MODE == 0;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t tsel = 0x20202020u * t;
  const int rows_live = min(r_count, (n_real + kCpr - 1) / kCpr);
  const int octs = (r_count + kOct - 1) / kOct;
  const uint4* src = reinterpret_cast<const uint4*>(codes) + lane;  // + 64 * oct

  // Copies the oct `ahead` steps past oct0 into its stage; one group a call.
  auto fetch = [&](int ahead) {
    const int oct = oct0 + ahead * oct_step;
    if (kReadsCodes && oct < octs) {
      const uint4* from = src + static_cast<size_t>(oct) * (kOct * 8);
      uint4* to = &ring[ahead % kStages][lane];
      if (oct * kOct + (lane >> 3) < rows_live) cp_async16(to, from);
      if (oct * kOct + 4 + (lane >> 3) < rows_live) cp_async16(to + 32, from + 32);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  // One row of the stage: its minima v (INT_MAX everywhere for a dead row).
  auto scan = [&](const uint4* stage, int rr, int row, int (&v)[MT][2]) {
    if (row >= rows_live) {
#pragma unroll
      for (int j = 0; j < MT; ++j) v[j][0] = v[j][1] = INT_MAX;
      return;
    }
    uint4 cw = make_uint4(0u, 0u, 0u, 0u);
    if (kReadsCodes) cw = stage[rr * 8 + g];
    if constexpr (MODE == 0) {  // the lab's copy: codes in, sentinel out
      const int x = kScanTrim | static_cast<int>((cw.x ^ cw.y ^ cw.z ^ cw.w) & zero);
#pragma unroll
      for (int j = 0; j < MT; ++j) v[j][0] = v[j][1] = x;
    } else {
      scan_row<CB, MT, MODE, kRows>(a, nt, cw, n_real - row * kCpr, t, tsel,
                                    static_cast<uint32_t>(row & zero), v);
    }
  };

  int step = 0;
  for (int oct = oct0; oct < octs; oct += oct_step, ++step) {
    __syncwarp();  // the stage fetched next was read in the step before
    fetch(step + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copy of this oct has landed
    const uint4* stage = ring[step % kStages];
    int keep[MT][2][2];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) keep[j][h][0] = keep[j][h][1] = INT_MAX;
#pragma unroll 1
    for (int pair = 0; pair < kOct / 2; ++pair) {
      const int row = oct * kOct + 2 * pair;
      if (row >= rows_live) break;  // no real code from here on: keep stays INT_MAX
      int v0[MT][2], v1[MT][2];
      scan(stage, 2 * pair, row, v0);
      scan(stage, 2 * pair + 1, row + 1, v1);
      if (t == pair) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j >= nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            keep[j][h][0] = v0[j][h];
            keep[j][h][1] = v1[j][h];
          }
        }
      }
    }
    const int row = oct * kOct + 2 * t;  // lane t stores rows 2t and 2t + 1 of the oct
    if (row >= r_count) continue;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (idx[j][h] < 0) continue;
        const size_t o = static_cast<size_t>(idx[j][h]) * r_count + row;
        const int2 r0 = row_result<CB, kRows>(keep[j][h][0], row);
        const int2 r1 = row_result<CB, kRows>(keep[j][h][1], row + 1);
        if (row + 1 < r_count && (o & 1) == 0) {  // 8-byte aligned: one vector store
          *reinterpret_cast<int2*>(out + o) = make_int2(r0.x, r1.x);
          if constexpr (kRows) *reinterpret_cast<int2*>(rows_out + o) = make_int2(r0.y, r1.y);
        } else {
          out[o] = r0.x;
          if constexpr (kRows) rows_out[o] = r0.y;
          if (row + 1 < r_count) {
            out[o + 1] = r1.x;
            if constexpr (kRows) rows_out[o + 1] = r1.y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing of this scan is in flight when the ring is reused
  __syncwarp();
}

// Blocks an SM should hold: as many as the A fragments' registers allow.
constexpr int min_blocks(int cb, int mt) { return cb * mt <= 8 ? 3 : (cb * mt <= 16 ? 2 : 1); }

// Flat scan: block (x, y) takes query group y (16*MT queries) and the octs
// x*8 + warp, stepping by the grid.
template <int CB, int MT, int MODE, bool kRows>
__global__ void __launch_bounds__(kMmaThreads, min_blocks(CB, MT))
flat_scan_mma_kernel(const uint8_t* __restrict__ codes,   // (R, 128)
                     const int8_t* __restrict__ tables,   // (Q, 2*CB, 16)
                     int32_t* __restrict__ out,           // (Q, R)
                     int32_t* __restrict__ rows_out,      // (Q, R), kRows only
                     int r_count, int q_count, int n, int zero) {
  __shared__ CodeRing rings[kMmaWarps];
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * 16 * MT;
  const int nt = min(MT, (q_count - q0 + 15) >> 4);
  int idx[MT][2];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 16 * j + (lane >> 2) + 8 * h;
      idx[j][h] = q < q_count ? q : -1;
    }
  uint32_t a[MT][CB][4];
  load_a<CB, MT>(a, nt, tables, idx, lane & 3);
  const int warp = threadIdx.x >> 5;
  scan_rows<CB, MT, MODE, kRows>(a, nt, codes, r_count, n, blockIdx.x * kMmaWarps + warp,
                                 gridDim.x * kMmaWarps, idx, out, rows_out, zero, rings[warp]);
}

// Blocks of `kernel` the current card holds at once.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, 0);
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  return err;
}

// One wave of blocks: every warp loads its A fragments once and walks its
// octs to the end.
template <int CB, int MT, int MODE, bool kRows>
cudaError_t launch_flat_mma(const void* codes, const void* tables, void* out, void* rows_out,
                            int r_count, int q_count, int n, cudaStream_t stream) {
  auto kernel = flat_scan_mma_kernel<CB, MT, MODE, kRows>;
  static int resident = 0;  // asked once for each instantiation
  if (resident == 0) {
    int blocks = 1;
    const cudaError_t err = resident_blocks(kernel, &blocks);
    if (err != cudaSuccess) return err;
    resident = blocks;
  }
  const int q_groups = (q_count + 16 * MT - 1) / (16 * MT);
  const int octs = (r_count + kOct - 1) / kOct;
  const int most = (octs + kMmaWarps - 1) / kMmaWarps;
  const int gx = resident / q_groups < 1 ? 1 : (resident / q_groups > most ? most : resident / q_groups);
  kernel<<<dim3(gx, q_groups), kMmaThreads, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<int32_t*>(out), static_cast<int32_t*>(rows_out), r_count, q_count, n, 0);
  return cudaGetLastError();
}

}  // namespace qadc
