// Kernels 7 and M1 with int8 tables (Quick ADC), redesigned for Hopper's
// tensor cores: the flat and the grouped 4-bit scan as an int8 product of
// the tables with the codes' one-hot (scan_mma.cuh).
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_tq / lut_scan_reduce at
// window == cpr (flat_scan_mma_kernel) and lut_scan_grouped_tq /
// lut_scan_grouped_prefetch with acc_dtype_name "int32"
// (grouped_scan_mma_kernel), which compute the scan the same way on the
// TPU's matrix unit. The output contracts, to the letter: per (query or
// pair, storage row) the minimum over the row's real codes of the int32 sum
// of the 2*CB selected table entries, no 127 saturation; 1 << 30 for a row
// with no real code (flat: at or past n; grouped: at or past the partition's
// size); with rows_out (flat only) the code index of the minimum, ties to
// the lower code, -1 for such a row; with tile_min (grouped only, rpp a
// multiple of 32) also per (pair, tile of 32 rows) the minimum of the tile's
// real rows as float32, +inf for a tile with none, for the screen that
// follows (ops/topk.py:exact_tile_screen). Float32 tables stay on lookup kernels
// (flat_scan.cu, flat_scan_qm.cuh, grouped_scan_sm.cu): their sums must keep
// rows_adc's order bit for bit.
//
// What bounds them on the H100: a one-lookup-per-lane scan is bound by
// shared-memory lookups, 32 a clock an SM (2.05 G lookups at 128 queries x
// 1M codes of 16 sub-quantizers: 0.28 ms at best). As a product the same
// scan is 67 G int8 operations, 34 us at the tensor cores' peak. With
// mma.sync the scan lab (scan_lab.cu) measures the product alone at 0.079 ms,
// the row minima (half-rate integer minima, quarter-rate shuffles) at 0.035
// and the one-hot build (half-rate shifts and byte permutes) at 0.02, and
// the three add up to the whole scan's 0.133 ms: a warp runs in order, and
// placing the minima between the products in program order made the scan
// slower (0.160-0.165 ms). An mma.sync that reads all its operands from
// registers is itself far from the tensor cores' rate; running the two tiles
// of an m-tile back to back, which read the same A registers, took the
// product alone from 0.089 to 0.079 ms. From 48 queries flat_scan therefore
// runs the warpgroup kernel of scan_wgmma.cu (0.069 ms); this kernel serves
// smaller batches, where its time follows the query count, and M1.
//
// Design of the flat kernel (scan_mma.cuh): a warp keeps the A fragments of
// 16*MT table rows in registers (MT = 1, 2 or 4 by the batch at CB = 8, so
// one one-hot build feeds up to four mma; 1 or 2 at CB = 16) and walks octs
// of eight storage rows, which it copies into its own shared-memory ring two
// octs ahead (cp.async; the codes stay in L2), building the B fragment in
// registers and storing one 32-byte sector per (query, oct). The flat grid is
// one wave of blocks, so A is loaded once a warp.
//
// M1 (grouped_scan_mma_kernel*) turns the product around: codes on the
// mma's M side, a group's live pairs on N. A = the one-hot of 16 codes (one
// storage row at CB = 8, two at CB = 16), B = the tables of 8 pairs (an N
// tile, in registers while the warp stays in the group), C = 16 codes x 8
// pairs: 8 mma.sync a row at CB = 8 for up to 8 live pairs, where 16 table
// rows on M took 16 whatever their live count. A group has ~3 live pairs
// when a batch probes thousands of lists (b = 512 x 24 probes of 4096) and
// ~12 over 256 lists (b = 128); its tile count follows its live count, up to
// G / 8, in chunks of NT tiles held in registers (NT = 2 at CB = 8 where the
// batch has more than 8 pairs a list, else 1: lut_scan.grouped_mma_tiles).
//
// The A fragment is built by byte permutes: k-step 2q + h of a code takes
// the four nibbles N_i of its bytes 2q, 2q + 1 (the 16-bit selector of a
// prmt) at the values 8h + t (k = 4t + i) and 8h + 4 + t (k = 16 + 4t + i),
// so each A register is one prmt of the lane's constant 1 << 8t (a source
// byte per value) by the code's nibbles, bit 3 flipped for h = 1 (a
// selector nibble with bit 3 set replicates a zero sign); B is the tables
// byte-transposed to match, once a group. That is 32 integer instructions
// a row for A, where a clamped shift a nibble took 64 (M1 at Deep100M's
// geometry 1.46 -> 1.27 ms on an H100 80GB HBM3). The integer pipe then
// bounds the scan: copying the codes alone and storing the rows took 0.40 ms.
//
// Three launches, none of whose shape depends on the data (CUDA-graph safe):
//   _plan (a warp a group): the live pairs packed, their count, the group's
//     cost (its real octs times a one-hot build a chunk plus a unit a tile);
//   _prefix (one block): the costs' prefix sum, and the real rows walked;
//   the scan, one wave of blocks: warp w walks the octs of its 1/W of the
//     cost prefix across groups, codes streaming through its ring three octs
//     ahead (HBM latency behind the compute of the octs before), a group's
//     tables loaded once when the walk enters it; between octs it writes
//     the sentinel rows of groups w, w + W, .. (past the group's last real
//     oct) by plain 16-byte stores. Blocks that would find no real row (2/3
//     of the padded grid of a list 2.7-3x the mean) are never launched.
// The tile minima: the plan sets every tile of each live pair to +inf; the
// scan folds each oct's row minima into a register per pair column (one
// 16-bit min an oct) and, where the warp's walk leaves a tile (its fourth
// oct, the group's last real oct, the end of the warp's share), folds the
// eight rows across the lanes and merges the tile by an atomic minimum on
// the float's bits: a share boundary may cut a tile between two warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_mma.cuh"

namespace {

using namespace qadc;

// ---- M1: a persistent walk over the real rows of the live groups

constexpr int kGroupedStages = 4;           // octs a warp keeps in flight or in use
using GroupedRing = uint4[kGroupedStages][kOct * 8];
constexpr int kPrefixThreads = 1024;
constexpr int kPrefixPerThread = 8;
constexpr int kNone16 = 0x7FFF;             // a 16-bit lane with no real code
constexpr uint32_t kNonePair = 0x7FFF7FFFu;
constexpr int kTileRows = 32;               // rows of a tile minimum (lut_scan.TILE)
constexpr int kTileOcts = kTileRows / kOct;
constexpr int kInfBits = 0x7F800000;        // +inf: above every sum's float bits

// A warp's cost of one oct of a group with `tiles` N tiles: a one-hot build
// (kOneHotCost) a chunk of NT tiles, and one unit a tile. Mirrored by
// lut_scan.grouped_scan_mma_plan.
constexpr int kOneHotCost = 4;

__device__ __forceinline__ int real_rows(int size, int rpp, int cpr) {
  return size <= 0 ? 0 : min(rpp, (size + cpr - 1) / cpr);
}

template <int NT>
__device__ __forceinline__ int oct_cost(int live) {
  const int tiles = (live + 7) / 8;
  return (tiles + NT - 1) / NT * kOneHotCost + tiles;
}

// The plan, a warp a group: its live pairs packed to the front of its row of
// live_pairs (any order: a pair owns its out row), their count, and
// base[g + 1] = the group's cost, octs * oct_cost, with its real rows in the
// high 32 bits (both 0 without a live pair); with tile_min, every tile of
// each live pair set to +inf for the scan's atomic minima.
template <int CB, int NT>
__global__ void __launch_bounds__(kMmaThreads)
grouped_scan_mma_kernel_plan(const int32_t* __restrict__ slot_pair,    // (gcap, G), -1 = empty
                             const int32_t* __restrict__ group_sizes,  // (gcap,)
                             int32_t* __restrict__ live_pairs,         // (gcap, G)
                             int32_t* __restrict__ live,               // (gcap,)
                             long long* __restrict__ base,             // (gcap + 2,)
                             int32_t* __restrict__ tile_min,           // (QA, rpp / 32) or null
                             int gcap, int group_size, int rpp) {
  const int grp = blockIdx.x * kMmaWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (grp >= gcap) return;
  const int32_t* slots = slot_pair + static_cast<size_t>(grp) * group_size;
  int32_t* packed = live_pairs + static_cast<size_t>(grp) * group_size;
  int n = 0;
  for (int s0 = 0; s0 < group_size; s0 += 32) {
    const int p = s0 + lane < group_size ? slots[s0 + lane] : -1;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, p >= 0);
    if (p >= 0) packed[n + __popc(m & ((1u << lane) - 1u))] = p;
    n += __popc(m);
  }
  if (lane == 0) {
    live[grp] = n;
    const int rows = n ? real_rows(group_sizes[grp], rpp, 128 / CB) : 0;
    base[grp + 1] = (static_cast<long long>(rows) << 32) |
                    static_cast<long long>((rows + kOct - 1) / kOct * oct_cost<NT>(n));
    if (grp == 0) base[0] = 0;
  }
  if (tile_min) {
    const int ntiles = rpp / kTileRows;
    __syncwarp();  // the lanes' packed pairs are visible to the warp
    for (int i = 0; i < n; ++i) {
      int32_t* row = tile_min + static_cast<size_t>(packed[i]) * ntiles;
      for (int t = lane; t < ntiles; t += 32) row[t] = kInfBits;
    }
  }
}

// base[1..gcap] (the plan's words) to the inclusive prefix sum of the
// groups' costs in place, and base[gcap + 1] = the real storage rows of the
// live groups (the rows the scan walks; read as the counter scan.rows): one
// block.
__global__ void __launch_bounds__(kPrefixThreads)
grouped_scan_mma_kernel_prefix(long long* __restrict__ base, int gcap) {
  __shared__ long long s_warp[kPrefixThreads / 32];
  __shared__ unsigned long long s_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_rows = 0;
  long long carry = 0;
  unsigned long long rows = 0;
  for (int first = 0; first < gcap; first += kPrefixThreads * kPrefixPerThread) {
    const int i0 = first + threadIdx.x * kPrefixPerThread;
    long long v[kPrefixPerThread];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kPrefixPerThread; ++k) {
      const long long word = i0 + k < gcap ? base[1 + i0 + k] : 0;
      rows += static_cast<unsigned long long>(word >> 32);
      v[k] = word & 0xFFFFFFFFll;
    }
#pragma unroll
    for (int k = 0; k < kPrefixPerThread; ++k) v[k] = sum += v[k];
    long long x = sum;  // the warp's inclusive scan of the threads' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = s_warp[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const long long before = carry + (warp ? s_warp[warp - 1] : 0) + x - sum;
#pragma unroll
    for (int k = 0; k < kPrefixPerThread; ++k)
      if (i0 + k < gcap) base[1 + i0 + k] = before + v[k];
    carry += s_warp[kPrefixThreads / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next round
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) rows += __shfl_down_sync(0xFFFFFFFFu, rows, d);
  if (lane == 0) atomicAdd(&s_rows, rows);
  __syncthreads();
  if (threadIdx.x == 0) base[gcap + 1] = static_cast<long long>(s_rows);
}

struct GroupedArgs {
  const uint8_t* codes;         // (P, rpp, 128)
  const int8_t* tables;         // (QA, 2*CB, 16)
  const int32_t* group_part;    // (gcap,)
  const int32_t* group_sizes;   // (gcap,) real codes
  const int32_t* live_pairs;    // (gcap, G), the plan's
  const int32_t* live;          // (gcap,)
  const long long* base;        // (gcap + 2,) prefix of the groups' costs, rows
  int32_t* out;                 // (QA, rpp)
  int32_t* tile_min;            // (QA, rpp / 32) float32 bits, or null
  int rpp, group_size, gcap;
};

// The largest g with base[g] <= x, for base[0] <= x < base[gcap]: a 32-way
// search, every lane a probe.
__device__ __forceinline__ int locate(const long long* __restrict__ base, int gcap, long long x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = gcap;  // base[lo] <= x < base[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, i < hi && base[i] <= x);
    if (m == 0) break;  // base[lo] > x: not a prefix (cannot happen)
    lo += (31 - __clz(m)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// One warp's place in its share of the octs: group g, oct o, up to oend.
struct OctCursor {
  int g, o, oend, live, size, rows;
  const uint8_t* part;
};

// The first oct whose first cost unit lies in [x, end), from the group
// holding x on; false if none.
template <int CB, int NT>
__device__ bool enter(OctCursor& c, long long x, long long end, const GroupedArgs& p) {
  while (x < end) {
    const int g = locate(p.base, p.gcap, x);
    const long long b0 = p.base[g];
    const int live = p.live[g];
    const int size = p.group_sizes[g];
    const int rows = real_rows(size, p.rpp, 128 / CB);
    const long long cost = oct_cost<NT>(live);
    const long long o = (x - b0 + cost - 1) / cost;
    const long long oend = min(static_cast<long long>((rows + kOct - 1) / kOct),
                               (end - b0 + cost - 1) / cost);
    if (o < oend) {
      c.g = g;
      c.o = static_cast<int>(o);
      c.oend = static_cast<int>(oend);
      c.live = live;
      c.size = size;
      c.rows = rows;
      c.part = p.codes + static_cast<size_t>(p.group_part[g]) * p.rpp * 128;
      return true;
    }
    x = p.base[g + 1];
  }
  return false;
}

template <int CB, int NT>
__device__ __forceinline__ bool next_oct(OctCursor& c, long long end, const GroupedArgs& p) {
  if (++c.o < c.oend) return true;
  return enter<CB, NT>(c, p.base[c.g + 1], end, p);
}

// B fragments of chunk `chunk` of the cursor's group (N tile j: pairs 8j..8j+7
// of the chunk, column gl = lane >> 2 this lane's; k-step 2q + h: byte i of
// b0 entry 8h + t, of b1 entry 8h + 4 + t, of table 4q + i) and the pair ids
// the lane stores for (columns 2t, 2t + 1); -1: no pair, zero tables.
template <int CB, int NT>
__device__ __forceinline__ void load_tiles(uint32_t (&bt)[NT][CB][2], int (&pid)[NT][2],
                                           const GroupedArgs& p, const OctCursor& c, int chunk) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t pick = static_cast<uint32_t>(t | ((t + 4) << 4));  // byte t of each word
  const int32_t* pairs = p.live_pairs + static_cast<size_t>(c.g) * p.group_size;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int s = (chunk * NT + j) * 8;
    const int pb = s + (lane >> 2) < c.live ? pairs[s + (lane >> 2)] : -1;
    const uint4* tab = reinterpret_cast<const uint4*>(
        p.tables + static_cast<size_t>(pb < 0 ? 0 : pb) * (32 * CB));
#pragma unroll
    for (int q = 0; q < CB / 2; ++q) {
      uint32_t w[4][4];  // tables 4q..4q+3, their 16 entries as 4 words
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = pb >= 0 ? __ldg(tab + 4 * q + i) : make_uint4(0u, 0u, 0u, 0u);
        w[i][0] = v.x; w[i][1] = v.y; w[i][2] = v.z; w[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)  // word u: entries 4u..4u+3 (h = u / 2, b0 / b1 by u & 1)
        bt[j][2 * q + u / 2][u & 1] = __byte_perm(__byte_perm(w[0][u], w[1][u], pick),
                                                  __byte_perm(w[2][u], w[3][u], pick), 0x5410);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) pid[j][e] = s + 2 * t + e < c.live ? pairs[s + 2 * t + e] : -1;
  }
}

// x[r] (r = the oct's row) to the minimum over the eight lanes of a column
// group, row gl = lane >> 2's in the lane: three exchanges of halving width
// (7 shuffles for 8 rows), min per 16-bit lane.
__device__ __forceinline__ uint32_t reduce_rows(uint32_t (&x)[kOct], int gl) {
  const bool u4 = gl & 4, u2 = gl & 2, u1 = gl & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t send = u4 ? x[k] : x[k + 4];
    const uint32_t keep = u4 ? x[k + 4] : x[k];
    x[k] = __vmins2(keep, __shfl_xor_sync(0xFFFFFFFFu, send, 16));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t send = u2 ? x[k] : x[k + 2];
    const uint32_t keep = u2 ? x[k + 2] : x[k];
    x[k] = __vmins2(keep, __shfl_xor_sync(0xFFFFFFFFu, send, 8));
  }
  const uint32_t send = u1 ? x[0] : x[1];
  const uint32_t keep = u1 ? x[1] : x[0];
  return __vmins2(keep, __shfl_xor_sync(0xFFFFFFFFu, send, 4));
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) { return __byte_perm(lo, hi, 0x5410); }

// PTX prmt.b32 in its default mode: byte i of the result is byte c[4i+2:4i]
// of (b:a), or that byte's sign replicated where bit 4i+3 of c is set
// (CUDA's __byte_perm does not replicate signs).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One oct of the cursor's group against NTC N tiles: the m-tiles (16 codes:
// one storage row at CB = 8, two at CB = 16) kPar at a time, the row minima
// per pair column in 16-bit lanes, reduced and stored one 32-byte sector per
// (pair, oct), and folded into tacc (the lane's row minima of the tile so
// far). The A fragment of a k-step is four permutes of the codes'
// nibbles (the head of this file). Four m-tiles at a time, or two sums an
// m-tile taking the k-steps in turns, were no faster (H100 80GB HBM3).
constexpr int kPar = 2;
template <int CB, int NT, int NTC, bool kWhole>
__device__ __forceinline__ void scan_oct(const uint32_t (&bt)[NT][CB][2], const int (&pid)[NT][2],
                                         const uint4* stage, const OctCursor& c,
                                         int32_t* __restrict__ out, int rpp,
                                         uint32_t (&tacc)[NT]) {
  constexpr int kCpr = 128 / CB;
  constexpr int kRowsPerTile = CB / 8;
  constexpr int kMTiles = kOct / kRowsPerTile;
  constexpr int kWords = CB / 4;  // words of one code
  const int lane = threadIdx.x & 31;
  const int gl = lane >> 2;
  const uint32_t one = 1u << (8 * (lane & 3));  // byte t of the one-hot tables
  const int row0 = c.o * kOct;
  uint32_t x[NTC][kOct];
#pragma unroll
  for (int mt = 0; mt < kMTiles; mt += kPar) {
    if (!kWhole && row0 + mt * kRowsPerTile >= c.rows) {  // no real code from here on
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int r = mt * kRowsPerTile; r < (mt + kPar) * kRowsPerTile; ++r) x[j][r] = kNonePair;
      continue;
    }
    // u: the code of C row gl, d: of C row gl + 8 (CB 8: codes gl and gl + 8
    // of the row; CB 16: code gl of the m-tile's first and second row).
    uint32_t u[kPar][kWords], d[kPar][kWords];
#pragma unroll
    for (int mi = 0; mi < kPar; ++mi) {
      const int mtile = mt + mi;
      if constexpr (CB == 8) {
        const uint2* row = reinterpret_cast<const uint2*>(stage) + mtile * 16;
        const uint2 cu = row[gl], cd = row[8 + gl];
        u[mi][0] = cu.x; u[mi][1] = cu.y; d[mi][0] = cd.x; d[mi][1] = cd.y;
      } else {
        const uint4 cu = stage[2 * mtile * 8 + gl], cd = stage[(2 * mtile + 1) * 8 + gl];
        u[mi][0] = cu.x; u[mi][1] = cu.y; u[mi][2] = cu.z; u[mi][3] = cu.w;
        d[mi][0] = cd.x; d[mi][1] = cd.y; d[mi][2] = cd.z; d[mi][3] = cd.w;
      }
    }
    int acc[kPar][NTC][4];
#pragma unroll
    for (int mi = 0; mi < kPar; ++mi)
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0;
#pragma unroll
    for (int wi = 0; wi < kWords; ++wi) {
#pragma unroll
      for (int qh = 0; qh < 4; ++qh) {  // k-step 2q + h, q = 2wi + qh / 2, h = qh % 2
        const int kk = 4 * wi + qh;
#pragma unroll
        for (int mi = 0; mi < kPar; ++mi) {
          // The selector: bytes 4wi, 4wi + 1 in the low 16 bits (q even) or
          // 4wi + 2, + 3; bit 3 of every nibble flipped for the values 8..15.
          uint32_t su = (qh & 1) ? u[mi][wi] ^ 0x88888888u : u[mi][wi];
          uint32_t sd = (qh & 1) ? d[mi][wi] ^ 0x88888888u : d[mi][wi];
          if (qh >= 2) {
            su >>= 16;
            sd >>= 16;
          }
          const uint32_t a[4] = {prmt(one, 0u, su), prmt(one, 0u, sd), prmt(0u, one, su),
                                 prmt(0u, one, sd)};
#pragma unroll
          for (int j = 0; j < NTC; ++j)
            mma_s8(acc[mi][j], a, bt[j][kk][0], bt[j][kk][1]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < kPar; ++mi) {
      const int mtile = mt + mi;
      const int real = c.size - (row0 + mtile * kRowsPerTile) * kCpr;  // of C row gl's row
#pragma unroll
      for (int j = 0; j < NTC; ++j) {
        int lo0 = acc[mi][j][0], hi0 = acc[mi][j][1], lo1 = acc[mi][j][2], hi1 = acc[mi][j][3];
        if constexpr (CB == 8) {  // C rows gl and gl + 8: codes gl and gl + 8 of one row
          if (!kWhole && real < kCpr) {
            if (gl >= real) lo0 = hi0 = kNone16;
            if (gl + 8 >= real) lo1 = hi1 = kNone16;
          }
          x[j][mtile] = pack2(min(lo0, lo1), min(hi0, hi1));
        } else {  // C rows gl and gl + 8: code gl of two rows
          if (!kWhole && real < 2 * kCpr) {
            if (gl >= real) lo0 = hi0 = kNone16;
            if (gl >= real - kCpr) lo1 = hi1 = kNone16;
          }
          x[j][2 * mtile] = pack2(lo0, hi0);
          x[j][2 * mtile + 1] = pack2(lo1, hi1);
        }
      }
    }
  }
  const int row = row0 + gl;
#pragma unroll
  for (int j = 0; j < NTC; ++j) {
    const uint32_t v = reduce_rows(x[j], gl);
    tacc[j] = __vmins2(tacc[j], v);
    if (row >= rpp) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pr = pid[j][e];
      const int m = e ? static_cast<int>(v) >> 16 : static_cast<int>(static_cast<int16_t>(v));
      if (pr >= 0) out[static_cast<size_t>(pr) * rpp + row] = m == kNone16 ? kScanTrim : m;
    }
  }
}

// scan_oct with the chunk's tile count (NT, or 1 for a group's last chunk)
// and whether every code of the oct is real as constants: no mma.sync under
// a predicate, no masks in the octs before a group's last.
template <int CB, int NT>
__device__ __forceinline__ void scan_chunk(const uint32_t (&bt)[NT][CB][2],
                                           const int (&pid)[NT][2], bool full_chunk,
                                           const uint4* stage, const OctCursor& c,
                                           int32_t* __restrict__ out, int rpp,
                                           uint32_t (&tacc)[NT]) {
  const bool whole = (c.o + 1) * kOct * (128 / CB) <= c.size;
  if (full_chunk && whole) scan_oct<CB, NT, NT, true>(bt, pid, stage, c, out, rpp, tacc);
  else if (full_chunk) scan_oct<CB, NT, NT, false>(bt, pid, stage, c, out, rpp, tacc);
  else if (whole) scan_oct<CB, NT, 1, true>(bt, pid, stage, c, out, rpp, tacc);
  else scan_oct<CB, NT, 1, false>(bt, pid, stage, c, out, rpp, tacc);
}

// The warp's share of tile `tile` (tacc: the lane's row gl, per pair column)
// to the minimum over the eight rows (exchanges xor 4, 8, 16), merged into
// each pair's tile_min on the float's bits (the plan set +inf): a sum >= 0
// (Quick ADC's tables) by a signed atomicMin, as non-negative floats order
// as their bits below every negative one's; a negative sum by an unsigned
// atomicMax, as negative floats order as their bits reversed, above every
// non-negative one's. tacc is reset.
template <int NT>
__device__ __forceinline__ void merge_tiles(uint32_t (&tacc)[NT], const int (&pid)[NT][2],
                                            int tile, const GroupedArgs& p) {
  const int lane = threadIdx.x & 31;
  const int ntiles = p.rpp / kTileRows;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t f = tacc[j];
    f = __vmins2(f, __shfl_xor_sync(0xFFFFFFFFu, f, 4));
    f = __vmins2(f, __shfl_xor_sync(0xFFFFFFFFu, f, 8));
    f = __vmins2(f, __shfl_xor_sync(0xFFFFFFFFu, f, 16));
    tacc[j] = kNonePair;
    if (lane >= 4) continue;  // lanes t = 0..3 hold columns 2t, 2t + 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pr = pid[j][e];
      const int m = e ? static_cast<int>(f) >> 16 : static_cast<int>(static_cast<int16_t>(f));
      if (pr < 0 || m == kNone16) continue;
      int32_t* at = p.tile_min + static_cast<size_t>(pr) * ntiles + tile;
      const int bits = __float_as_int(static_cast<float>(m));
      if (m >= 0) atomicMin(at, bits);
      else atomicMax(reinterpret_cast<unsigned int*>(at), static_cast<unsigned int>(bits));
    }
  }
}

// n int32 entries of kScanTrim from dst on, by one warp: 16-byte stores
// between the aligned ends.
__device__ __forceinline__ void fill_trim(int32_t* dst, int n) {
  const int lane = threadIdx.x & 31;
  if (n <= 0) return;
  const int head = min(n, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
  if (lane < head) dst[lane] = kScanTrim;
  const int quads = (n - head) >> 2;
  int4* body = reinterpret_cast<int4*>(dst + head);
  for (int i = lane; i < quads; i += 32) body[i] = make_int4(kScanTrim, kScanTrim, kScanTrim, kScanTrim);
  if (lane < ((n - head) & 3)) dst[head + 4 * quads + lane] = kScanTrim;
}

// The sentinel rows a warp writes: rows from the group's last real oct on,
// for each live pair of its live groups g, g + W, ..; pair i of group g
// from row pos on (first: the group's first such row).
struct DeadRows {
  int g, i, pos, live, first;
};
constexpr int kDeadSlice = 1024;  // entries a warp writes after each oct it scans

template <int CB>
__device__ __forceinline__ void next_dead_group(DeadRows& d, int warps, const GroupedArgs& p) {
  for (; d.g < p.gcap; d.g += warps) {
    d.live = p.live[d.g];
    d.first = min(p.rpp, (real_rows(p.group_sizes[d.g], p.rpp, 128 / CB) + kOct - 1) / kOct * kOct);
    if (d.live > 0 && d.first < p.rpp) {
      d.i = 0;
      d.pos = d.first;
      return;
    }
  }
}

// Up to `budget` of the warp's sentinel entries, by 16-byte stores.
template <int CB>
__device__ __forceinline__ void dead_rows(DeadRows& d, int budget, int warps, const GroupedArgs& p) {
  while (d.g < p.gcap && budget > 0) {
    const int n = min(budget, p.rpp - d.pos);
    const int pr = p.live_pairs[static_cast<size_t>(d.g) * p.group_size + d.i];
    fill_trim(p.out + static_cast<size_t>(pr) * p.rpp + d.pos, n);
    budget -= n;
    d.pos += n;
    if (d.pos == p.rpp) {
      d.pos = d.first;
      if (++d.i == d.live) {
        d.g += warps;
        next_dead_group<CB>(d, warps, p);
      }
    }
  }
}

// M1: one wave of blocks; warp w of W walks the octs whose first cost unit
// lies in [w, w + 1) * total / W of the groups' cost prefix, codes through
// its own ring kGroupedStages - 1 octs ahead (cp.async, across groups), the
// tables of a group's first NT tiles held in registers while the group lasts
// (more tiles: reloaded an oct), and writes its sentinel rows (DeadRows)
// kDeadSlice entries after each oct, the rest at the end. kTiles (tile_min
// set) merges a tile where the walk leaves it (a group of one chunk), or
// each oct's (more chunks: the pairs change within the oct). A constant: the
// merges' code alone, never run, cost the scan 4% (H100 80GB HBM3, Deep100M's
// geometry), so a call without tile_min runs the instantiation without it.
template <int CB, int NT, bool kTiles>
__global__ void __launch_bounds__(kMmaThreads, 2)
grouped_scan_mma_kernel(const GroupedArgs p) {
  __shared__ GroupedRing rings[kMmaWarps];
  constexpr int kCpr = 128 / CB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = gridDim.x * kMmaWarps;
  const int w = blockIdx.x * kMmaWarps + warp;

  DeadRows dead{w, 0, 0, 0, 0};
  next_dead_group<CB>(dead, warps, p);

  const long long total = p.base[p.gcap];
  const long long end = total * (w + 1) / warps;
  OctCursor fc;
  bool fetching = enter<CB, NT>(fc, total * w / warps, end, p);
  OctCursor cc = fc;
  bool scanning = fetching;
  GroupedRing& ring = rings[warp];
  int fstep = 0;
  // Copies the fetch cursor's oct into its stage and moves the cursor on;
  // one cp.async group a call, empty past the warp's last oct.
  auto fetch = [&]() {
    if (fetching) {
      const uint4* from = reinterpret_cast<const uint4*>(fc.part) + static_cast<size_t>(fc.o) * 64 + lane;
      uint4* to = &ring[fstep % kGroupedStages][lane];
      const int row = fc.o * kOct + (lane >> 3);
      if (row < fc.rows) cp_async16(to, from);
      if (row + 4 < fc.rows) cp_async16(to + 32, from + 32);
      fetching = next_oct<CB, NT>(fc, end, p);
    }
    cp_async_commit();
    ++fstep;
  };
#pragma unroll
  for (int k = 0; k < kGroupedStages - 1; ++k) fetch();

  uint32_t bt[NT][CB][2];
  int pid[NT][2];
  uint32_t tacc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) tacc[j] = kNonePair;
  int tiles = 0, chunks = 0, held = -1;
  for (int step = 0; scanning; ++step) {
    if (cc.g != held) {
      held = cc.g;
      tiles = (cc.live + 7) / 8;
      chunks = (tiles + NT - 1) / NT;
      if (chunks == 1) load_tiles<CB, NT>(bt, pid, p, cc, 0);
    }
    __syncwarp();  // the stage fetched next was read in the step before
    fetch();
    cp_async_wait<kGroupedStages - 1>();
    __syncwarp();  // every lane's copy of this oct has landed
    const uint4* stage = ring[step % kGroupedStages];
    for (int ch = 0; ch < chunks; ++ch) {
      if (chunks > 1) load_tiles<CB, NT>(bt, pid, p, cc, ch);
      scan_chunk<CB, NT>(bt, pid, tiles - ch * NT >= NT, stage, cc, p.out, p.rpp, tacc);
      if (kTiles && chunks > 1) merge_tiles<NT>(tacc, pid, cc.o / kTileOcts, p);
    }
    if (kTiles && chunks == 1 && (cc.o % kTileOcts == kTileOcts - 1 || cc.o + 1 == cc.oend))
      merge_tiles<NT>(tacc, pid, cc.o / kTileOcts, p);
    scanning = next_oct<CB, NT>(cc, end, p);
    if (dead.g < p.gcap) dead_rows<CB>(dead, kDeadSlice, warps, p);
  }
  cp_async_wait<0>();
  dead_rows<CB>(dead, INT_MAX, warps, p);
}

// The scan kernel, one wave of its resident blocks.
template <int CB, int NT, bool kTiles>
cudaError_t launch_scan(const GroupedArgs& args, cudaStream_t stream) {
  auto kernel = grouped_scan_mma_kernel<CB, NT, kTiles>;
  static int resident = 0;  // asked once for each instantiation
  if (resident == 0) {
    int blocks = 1;
    const cudaError_t err = resident_blocks(kernel, &blocks);
    if (err != cudaSuccess) return err;
    resident = blocks;
  }
  kernel<<<resident, kMmaThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

template <int CB, int NT>
cudaError_t launch_grouped(const GroupedArgs& args, const void* slot_pair, void* live_pairs,
                           void* live, void* base, cudaStream_t stream) {
  static_assert(NT == 1 || NT == 2, "scan_oct takes a chunk of 1 or NT tiles");
  grouped_scan_mma_kernel_plan<CB, NT>
      <<<(args.gcap + kMmaWarps - 1) / kMmaWarps, kMmaThreads, 0, stream>>>(
          static_cast<const int32_t*>(slot_pair), args.group_sizes,
          static_cast<int32_t*>(live_pairs), static_cast<int32_t*>(live),
          static_cast<long long*>(base), args.tile_min, args.gcap, args.group_size, args.rpp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grouped_scan_mma_kernel_prefix<<<1, kPrefixThreads, 0, stream>>>(static_cast<long long*>(base),
                                                                   args.gcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return args.tile_min ? launch_scan<CB, NT, true>(args, stream)
                       : launch_scan<CB, NT, false>(args, stream);
}

// The fewest m-tiles a warp (1, 2 or at most `most`) that cover q_count queries.
template <int CB, int MOST, bool kRows>
cudaError_t launch_flat(const void* codes, const void* tables, void* out, void* rows_out,
                        int r_count, int q_count, int n, cudaStream_t stream) {
  if (q_count <= 16)
    return launch_flat_mma<CB, 1, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                n, stream);
  if (q_count <= 32 || MOST == 2)
    return launch_flat_mma<CB, 2, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                n, stream);
  return launch_flat_mma<CB, MOST, kFull, kRows>(codes, tables, out, rows_out, r_count, q_count,
                                                 n, stream);
}

}  // namespace

// int8 tables, int32 out (Q, R); rows_out (Q, R) may be null (minima only).
// n: real code count, 0 <= n <= r_count * cpr.
extern "C" int qadc_flat_scan_mma(const void* codes, const void* tables, void* out,
                                  void* rows_out, int r_count, int q_count, int n, int cb,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && rows_out)
    return launch_flat<8, 4, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 8)
    return launch_flat<8, 4, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  if (cb == 16 && rows_out)
    return launch_flat<16, 2, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 16)
    return launch_flat<16, 2, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 tables, int32 out (QA, rpp); tile_min (QA, rpp / 32) float32 or null
// (rpp a multiple of 32 with it); live_pairs (gcap, G) int32, live (gcap,)
// int32 and base (gcap + 2,) int64 are the plan's scratch (base[gcap + 1]:
// the real rows walked); tiles: the N tiles of 8 pairs a warp holds in
// registers (1, or 2 at cb 8).
extern "C" int qadc_grouped_scan_mma(const void* codes, const void* tables,
                                     const void* group_part, const void* slot_pair,
                                     const void* group_sizes, void* out, void* tile_min,
                                     void* live_pairs, void* live, void* base, int gcap,
                                     int group_size, int rpp, int cb, int tiles, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (group_size < 1 || gcap < 1 || rpp < 1 || (tile_min && rpp % kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const GroupedArgs args{static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
                         static_cast<const int32_t*>(group_part),
                         static_cast<const int32_t*>(group_sizes),
                         static_cast<const int32_t*>(live_pairs),
                         static_cast<const int32_t*>(live), static_cast<const long long*>(base),
                         static_cast<int32_t*>(out), static_cast<int32_t*>(tile_min), rpp,
                         group_size, gcap};
  if (cb == 8 && tiles == 1) return launch_grouped<8, 1>(args, slot_pair, live_pairs, live, base, s);
  if (cb == 8 && tiles == 2) return launch_grouped<8, 2>(args, slot_pair, live_pairs, live, base, s);
  if (cb == 16 && tiles == 1)
    return launch_grouped<16, 1>(args, slot_pair, live_pairs, live, base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
