// Kernels M2 (rows_adc) and M3 (direct_scan): exact float32 ADC of 4-bit PQ
// codes stored as 128-byte rows, each kernel with its own entry point. M3
// sums a code by one per-code device function (adc_code); the staged M2 sums
// the same terms in the same order from its own layout (adc_code_staged).
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
// direct path calls it (b=1, and any batch sent or forced there) (compact_out, mask_sizes, tile_min=32): every
// code of each probed partition is scored with its pair's table, codes at or
// past the partition's size hold MASK_BIG, and the minima of 32-code tiles
// are written beside the distances. The output is in code order, (QA,
// part_pad), not the Pallas kernel's c-major transposed layout.
//
// What bounds them on the H100: M3 reads each probed partition's codes (8
// bytes a code at 16x4 PQ) and writes 4 bytes of distance a code and pair
// (see its design below). M2 moves little (its rows repeat: the flat keep-prefix
// scores the same 625 rows for every query; each table is 1 KB at CB = 8),
// so it is bound by latency: a chain of dependent loads (ids, then codes and
// tables) in blocks that live a few microseconds, and by its 2*CB table
// lookups a code (20.5 M in the flat keep-prefix at b=128).
//
// M2's design (rows_adc_kernel): a block takes a tile of kTile = 16
// consecutive entries, one thread a code (a half-warp reads a row at CB = 8,
// a quarter-warp at CB = 16). Runs of equal pair ids are found in the tile
// (no sort, the callers' order: the flat keep-prefix has one pair for 625
// rows, the IVF keep-prefix runs of ppr, the rerank runs of about 2 in screen
// order). Each run's two tables are staged once in shared memory (a slot),
// by the warp that holds the run's first row: coalesced 16-byte loads issued
// together with the code loads, since both need only the ids (the ballot that
// numbers the runs is taken while they are in flight). A slot holds each
// table as rows of 16 words by byte position (staged_word: two swizzles make
// the staging stores conflict-free); a slot is 32*CB + 16 words, 16 more
// than 32 banks divide, and consecutive runs take consecutive slots, so the
// two rows of a warp at CB = 8 look up in opposite bank halves: each lookup
// at a fixed byte position is one wavefront. (At CB = 16 four rows share a
// warp, and distinct pairs may meet 2-way.) Nibble offsets come four at a
// time from one mask and a byte permute. Measured on the card, tiles of 16
// (17 KB of shared memory a block at CB = 8) beat tiles of 32 (35 KB) at
// every shape but the flat keep-prefix, where they tie: more and smaller
// blocks, each waiting at its barrier for fewer warps.
//
// M3's design (direct_scan_kernel): a block takes an item, a pair and a
// chunk of `rounds` x 1024 consecutive codes of its partition (the wrapper
// picks rounds, lut_scan.direct_scan_rounds: 4 where the grid still has a
// block an SM, else 1, as at b=1; from a sweep of fixed rounds), and stages
// the pair's two compact tables once in shared memory, transposed to
// [byte][centroid], so a warp's lookups at one byte position hit 16 banks
// without conflict. A lane holds 4 consecutive codes a round (two or four
// 16-byte loads); the first round's code loads are issued right after the
// partition id, before the tables are stored and the barrier, and each
// round's loads go out before the round before it is summed. A lane writes
// its 4 distances as one 16-byte store, and a 32-code tile minimum is the
// minimum of a lane's 4 sums and three xor-shuffles over its 8 lanes.
// What bounds it: at b=1 (24 pairs, 4,096 codes each at the bench's 16x4
// index) a launch and two dependent loads, a pair's partition id and then
// its codes; at the direct path's larger batches the 4 bytes of distance it
// writes a code and pair (151 MB at b=128 over part_pad 12,288) and its 2*CB
// shared-memory lookups a real code. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py) it runs at 63% of its bytes bound there and 1.65-2.34x
// faster than the block-a-256-codes kernel it replaced from b=32 on; which of
// the two holds it back is not measured.
//
// All sums run in float32 in the order b = 0..CB-1, low then high nibble,
// with no contraction (only adds), which the plain PyTorch versions repeat:
// the kernels agree bit for bit.

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

// Float ADC distance of one code: sum over bytes b of lo[b][j_lo] + hi[b][j_hi],
// where lo/hi hold sub-quantizers 2b / 2b+1 transposed to [byte][centroid].
template <int CB>
__device__ __forceinline__ float adc_code(const uint32_t* w, const float* lo,
                                          const float* hi) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t byte = (w[b >> 2] >> ((b & 3) * 8)) & 0xFFu;
    acc += lo[b * 16 + (byte & 15u)];
    acc += hi[b * 16 + (byte >> 4)];
  }
  return acc;
}

// M2's tile: entries (storage rows) a block.
constexpr int kTile = 16;

template <int CB>
struct Staged {
  static constexpr int kCpr = 128 / CB;
  static constexpr int kThreads = kTile * kCpr;         // a thread a code: 256 / 128
  static constexpr int kRowsPerWarp = 32 / kCpr;        // 2 / 4
  static constexpr int kLoads = CB / 8;                 // float4s a lane loads of a table
  static constexpr int kHi = 16 * CB;                   // words from a slot's lo to its hi table
  static constexpr int kSlot = 32 * CB + 16;            // words a slot: 16 (mod 32)
  static constexpr int kSmem = kTile * kSlot * 4;       // 17,408 / 33,792 bytes
};

// Word of (byte position b, centroid j) in a staged table: a row of 16 words
// a byte position, rows b >= 4 of each group of 8 swapped in pairs and
// centroids of bytes 8-15 flipped by 8, so that a warp's staging stores
// (lane l: float4 l of the table, centroid j and four byte positions) fall
// in 32 distinct banks; a lookup at one b reads 16 consecutive words.
__host__ __device__ constexpr int staged_row(int b) { return b ^ ((b >> 2) & 1); }
__host__ __device__ constexpr int staged_word(int b, int j) {
  return staged_row(b) * 16 + (j ^ (((b >> 3) & 1) * 8));
}

// adc_code over one staged slot: 4 * nibble of four code bytes from one mask
// each (the centroid swizzle folded in), a byte permute a lookup.
template <int CB>
__device__ __forceinline__ float adc_code_staged(const uint32_t* w, const float* lo,
                                                 const float* hi) {
  const char* l = reinterpret_cast<const char*>(lo);
  const char* h = reinterpret_cast<const char*>(hi);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < CB / 4; ++q) {
    const uint32_t swz = q >= 2 ? 0x20202020u : 0u;          // j ^ 8 for bytes 8-15
    const uint32_t l4 = ((w[q] << 2) & 0x3C3C3C3Cu) ^ swz;   // 4 * low nibble a byte
    const uint32_t h4 = ((w[q] >> 2) & 0x3C3C3C3Cu) ^ swz;   // 4 * high nibble
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = staged_row(4 * q + k) * 64;            // bytes
      acc += *reinterpret_cast<const float*>(l + row + __byte_perm(l4, 0, 0x4440 + k));
      acc += *reinterpret_cast<const float*>(h + row + __byte_perm(h4, 0, 0x4440 + k));
    }
  }
  return acc;
}

template <int CB>
__global__ void __launch_bounds__(Staged<CB>::kThreads)
rows_adc_kernel(const uint8_t* __restrict__ codes,   // (R, 128) all storage rows
                const int32_t* __restrict__ row_ids, // (A,)
                const int32_t* __restrict__ pair_ids,// (A,)
                const float* __restrict__ tlo,       // (QA, 16*CB), lane j*CB + b
                const float* __restrict__ thi,
                float* __restrict__ out,             // (A, cpr)
                int a_count) {
  using L = Staged<CB>;
  extern __shared__ float s_tab[];  // kTile slots: [lo | hi | 16 pad], each staged_word
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int live = static_cast<int>(min(static_cast<long long>(kTile), a_count - tile0));
  const int t = threadIdx.x / L::kCpr, c = threadIdx.x % L::kCpr;  // this thread's code
  const int e0 = warp * L::kRowsPerWarp;                            // the warp's first entry

  // The ids: this thread's row; the pairs of the warp's rows and of the entry
  // before them (the same address across the warp); lane e's pair for the
  // ballot below.
  const int row = t < live ? row_ids[tile0 + t] : 0;
  int p[L::kRowsPerWarp + 1];
#pragma unroll
  for (int i = 0; i <= L::kRowsPerWarp; ++i) {
    const int e = e0 + i - 1;
    p[i] = e >= 0 && e < live ? pair_ids[tile0 + e] : -1;
  }
  const int pair = lane < live ? pair_ids[tile0 + lane] : -1;

  // The code's bytes, and the tables of each run that starts in the warp's
  // rows (entry e starts one if e == 0 or its pair differs from e-1's), all
  // in flight together: nothing but the ids stands before them.
  uint32_t w[CB / 4];
  if (t < live) CodeBytes<CB>::load(codes + static_cast<size_t>(row) * 128 + c * CB, w);
  float4 v[L::kRowsPerWarp][2][L::kLoads];
#pragma unroll
  for (int i = 0; i < L::kRowsPerWarp; ++i) {
    if (p[i + 1] >= 0 && (e0 + i == 0 || p[i + 1] != p[i])) {
      const auto* lo4 = reinterpret_cast<const float4*>(tlo + static_cast<size_t>(p[i + 1]) * 16 * CB);
      const auto* hi4 = reinterpret_cast<const float4*>(thi + static_cast<size_t>(p[i + 1]) * 16 * CB);
#pragma unroll
      for (int h = 0; h < L::kLoads; ++h) {
        v[i][0][h] = __ldg(lo4 + 32 * h + lane);
        v[i][1][h] = __ldg(hi4 + 32 * h + lane);
      }
    }
  }

  // Runs of the tile: bit e of `starts` is set where one starts; a run's
  // slot is its index (runs before it), consecutive runs, consecutive slots.
  const int prev = __shfl_up_sync(0xffffffffu, pair, 1);
  const unsigned starts = __ballot_sync(0xffffffffu, lane < live && (lane == 0 || pair != prev));
#pragma unroll
  for (int i = 0; i < L::kRowsPerWarp; ++i) {
    const int e = e0 + i;
    if ((starts >> e) & 1u) {
      float* slot = s_tab + (__popc(starts & ((2u << e) - 1u)) - 1) * L::kSlot;
#pragma unroll
      for (int tab = 0; tab < 2; ++tab) {
#pragma unroll
        for (int h = 0; h < L::kLoads; ++h) {
          const int f = 32 * h + lane;  // global lanes 4f .. 4f+3 = j * CB + b0 .. b0+3
          const int j = 4 * f / CB, b0 = 4 * f % CB;
          float* dst = slot + tab * L::kHi;
          dst[staged_word(b0 + 0, j)] = v[i][tab][h].x;
          dst[staged_word(b0 + 1, j)] = v[i][tab][h].y;
          dst[staged_word(b0 + 2, j)] = v[i][tab][h].z;
          dst[staged_word(b0 + 3, j)] = v[i][tab][h].w;
        }
      }
    }
  }
  __syncthreads();
  if (t < live) {
    const float* lo = s_tab + (__popc(starts & ((2u << t) - 1u)) - 1) * L::kSlot;
    out[(tile0 + t) * L::kCpr + c] = adc_code_staged<CB>(w, lo, lo + L::kHi);
  }
}

template <int CB>
cudaError_t launch_rows_adc(const void* codes, const void* row_ids, const void* pair_ids,
                            const void* tlo, const void* thi, void* out, int a_count,
                            cudaStream_t stream) {
  using L = Staged<CB>;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(a_count) + kTile - 1)
                                                / kTile);
  rows_adc_kernel<CB><<<blocks, L::kThreads, L::kSmem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(pair_ids), static_cast<const float*>(tlo),
      static_cast<const float*>(thi), static_cast<float*>(out), a_count);
  return cudaGetLastError();
}

// M3: codes a lane holds a round, and codes a block round.
constexpr int kDirectCodes = 4;
constexpr int kDirectRound = kThreads * kDirectCodes;  // 1024

template <int CB>
__global__ void __launch_bounds__(kThreads)
direct_scan_kernel(const uint8_t* __restrict__ codes,    // (P, part_pad, CB)
                   const int32_t* __restrict__ pair_part,// (QA,)
                   const float* __restrict__ tlo,        // (QA, 16*CB), lane j*CB + b
                   const float* __restrict__ thi,
                   const int32_t* __restrict__ sizes,    // (QA,) real codes
                   float* __restrict__ out,              // (QA, part_pad)
                   float* __restrict__ mins,             // (QA, part_pad / 32)
                   int part_pad, int chunks, int rounds) {
  constexpr int kTab = 16 * CB;          // entries of one table
  constexpr int kStage = 2 * kTab / kThreads;  // table entries a thread stages: 1 / 2
  constexpr int kVecs = CB * kDirectCodes / 16;  // 16-byte loads a lane a round: 2 / 4
  __shared__ float s_tab[2 * kTab];      // [lo | hi], each [b][j]
  const int pair = blockIdx.x / chunks;
  const int chunk = blockIdx.x - pair * chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The tables (nothing stands before them), then the partition and size,
  // then the first round's codes: all in flight before the barrier.
  float tv[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = threadIdx.x + u * kThreads;  // i < kTab: lo, else hi
    tv[u] = __ldg((i < kTab ? tlo : thi) + static_cast<size_t>(pair) * kTab + i % kTab);
  }
  const int size = min(sizes[pair], part_pad);
  const uint4* part = reinterpret_cast<const uint4*>(
      codes + static_cast<size_t>(pair_part[pair]) * part_pad * CB);
  // This lane's first code in round r: base + r * kDirectRound.
  const int base = chunk * rounds * kDirectRound + warp * 128 + lane * kDirectCodes;
  auto load = [&](int r, uint4 (&v)[kVecs]) {
    const int c0 = base + r * kDirectRound;
    if (r < rounds && c0 < size) {  // codes past the size but in storage may be read
#pragma unroll
      for (int k = 0; k < kVecs; ++k) v[k] = __ldg(part + static_cast<size_t>(c0) * CB / 16 + k);
    }
  };
  uint4 cur[kVecs], nxt[kVecs];
  load(0, cur);
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = (threadIdx.x + u * kThreads) % kTab;  // lane j*CB + b of its table
    s_tab[(threadIdx.x + u * kThreads) / kTab * kTab + (i % CB) * 16 + i / CB] = tv[u];
  }
  __syncthreads();

  float* row = out + static_cast<size_t>(pair) * part_pad;
  float* row_mins = mins + static_cast<size_t>(pair) * (part_pad / 32);
  for (int r = 0; r < rounds; ++r) {
    load(r + 1, nxt);  // the next round's codes, on their way during this one's sums
    const int c0 = base + r * kDirectRound;
    if (c0 < part_pad) {  // the same for the whole warp: part_pad % 128 == 0
      uint32_t w[4 * kVecs];  // the lane's codes, CB / 4 words each
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        w[4 * k] = cur[k].x;
        w[4 * k + 1] = cur[k].y;
        w[4 * k + 2] = cur[k].z;
        w[4 * k + 3] = cur[k].w;
      }
      float d[kDirectCodes];
#pragma unroll
      for (int k = 0; k < kDirectCodes; ++k)
        d[k] = c0 + k < size ? adc_code<CB>(w + k * (CB / 4), s_tab, s_tab + kTab)
                             : kMaskBig;
      *reinterpret_cast<float4*>(row + c0) = make_float4(d[0], d[1], d[2], d[3]);
      float m = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // 8 lanes hold a 32-code tile
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      if ((lane & 7) == 0) row_mins[c0 / 32] = m;
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) cur[k] = nxt[k];
  }
}

}  // namespace

extern "C" int qadc_rows_adc(const void* codes, const void* row_ids, const void* pair_ids,
                             const void* tlo, const void* thi, void* out, int a_count,
                             int cb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (a_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8)
    return static_cast<int>(launch_rows_adc<8>(codes, row_ids, pair_ids, tlo, thi, out,
                                               a_count, s));
  if (cb == 16)
    return static_cast<int>(launch_rows_adc<16>(codes, row_ids, pair_ids, tlo, thi, out,
                                                a_count, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// M3: rounds (>= 1) of 1024 codes a block; part_pad % 256 == 0.
extern "C" int qadc_direct_scan(const void* codes, const void* pair_part, const void* tlo,
                                const void* thi, const void* sizes, void* out, void* mins,
                                int qa, int part_pad, int cb, int rounds, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (qa < 1 || rounds < 1 || part_pad < 256 || part_pad % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_chunk = static_cast<long long>(rounds) * kDirectRound;
  const int chunks = static_cast<int>((part_pad + per_chunk - 1) / per_chunk);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(qa) * chunks);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* pp = static_cast<const int32_t*>(pair_part);
  const auto* lo = static_cast<const float*>(tlo);
  const auto* hi = static_cast<const float*>(thi);
  const auto* sz = static_cast<const int32_t*>(sizes);
  auto* o = static_cast<float*>(out);
  auto* m = static_cast<float*>(mins);
  if (cb == 8)
    direct_scan_kernel<8><<<blocks, kThreads, 0, s>>>(c, pp, lo, hi, sz, o, m, part_pad, chunks,
                                                      rounds);
  else if (cb == 16)
    direct_scan_kernel<16><<<blocks, kThreads, 0, s>>>(c, pp, lo, hi, sz, o, m, part_pad, chunks,
                                                       rounds);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
