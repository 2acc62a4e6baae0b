// Kernel 7 with int8 tables at large batches: the flat 4-bit scan as a
// warpgroup product (wgmma) of the tables with a one-hot written to shared
// memory.
//
// Replaces: qadc_tpu/kernels/lut_scan.py:lut_scan_tq / lut_scan_reduce at
// window == cpr, as flat_scan_mma_kernel (scan_mma.cu) does, with the same
// output contract to the letter: per (query, storage row) the minimum over the
// row's real codes of the int32 sum of the 2*CB selected int8 entries;
// 1 << 30 for a row with no real code; with rows_out the code index of the
// minimum, ties to the lower code, -1 for such a row.
//
// What bounds it on the H100: the scan lab (scan_lab.cu) shows that with
// mma.sync the product, the one-hot build and the row minimum add up instead
// of overlapping: a warp runs in order, and an mma.sync whose operands all
// come from registers runs well below the tensor cores' rate. wgmma is
// asynchronous and reads its B operand from shared memory, so one warpgroup
// can build the one-hot while two others multiply and reduce. Per tile of
// 128 codes x 128 queries the product is 4.2 M multiply-adds (about 980
// clocks of an SM's tensor cores at their peak), against 32 KB of one-hot
// written once and read twice (96 bytes a clock of the 128 shared memory
// moves).
//
// Design: a block is three warpgroups and walks tiles of 128 codes (8
// storage rows at CB = 8, 16 at CB = 16), one block an SM.
//   producer (warpgroup 2): thread p takes code p of the tile and writes its
//     one-hot, 16 bytes a sub-quantizer with a single 1, into a stage of the
//     ring, in the layout wgmma reads: 8 x 16-byte core matrices, [code / 8]
//     [sub-quantizer][code % 8][16]. Eight lanes write one core matrix, 128
//     contiguous bytes, so the stores have no bank conflicts.
//   consumers (warpgroups 0 and 1, 64 queries each): the tables are the A
//     operand, held in registers for the whole kernel in the m16n8k32
//     fragment layout (warp w of the group has queries 16w .. 16w + 15). One
//     k-step is one code byte: wgmma m64n128k32 with B = the stage's two
//     core-matrix columns of that byte. After the tile's CB products the
//     group takes each storage row's minimum from its accumulators (columns
//     are codes; four values a lane, then two xor-shuffles), and lane t
//     stores a quarter of the tile's rows as whole 32-byte sectors. The two
//     groups start their products in turns, so that while one reduces, the
//     other's products keep the tensor cores busy (0.069 ms against 0.071
//     without the turns, 128 queries x 1M codes on an H100).
// Stages are handed over with named barriers (full: the producer arrives, a
// consumer group waits; empty: the reverse); a fence.proxy.async orders the
// producer's stores before the products that read them.
//
// flat_scan_window_wgmma_kernel (kernels 8, 8v, 8w with int8 tables: window
// minima at any block_n and window) is the same pipeline over the
// window-major columns of window_columns.cuh, with its own epilogue
// (window_epilogue); its note is beside it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "window_columns.cuh"

namespace {

constexpr int kTrim = 1 << 30;   // lut_scan.TRIM_SENTINEL
constexpr int kTile = 128;       // codes a tile: the products' N
constexpr int kThreads = 384;    // two consumer warpgroups and the producer
// Lab mode bits (as in scan_mma.cuh): the parts of the scan a kernel keeps.
constexpr int kExpand = 1;  // the producer reads the codes and writes the one-hot
constexpr int kMma = 2;     // the products
constexpr int kMin = 4;     // the row minima (masks, shuffles)
constexpr int kFull = kExpand | kMma | kMin;
// Named barriers. A stage is full for each consumer group apart (the
// producer arrives on both, a group waits on its own: the groups need not
// keep step); it is empty for the producer once both groups have arrived.
__device__ __forceinline__ int full_barrier(int stage, int group) { return 1 + 2 * stage + group; }
__device__ __forceinline__ int empty_barrier(int stage) { return 7 + stage; }
// The consumer groups start their products in turns (group 0 first), so that
// one group's products run while the other takes its minima.
__device__ __forceinline__ int turn_barrier(int group) { return 10 + group; }

template <int CB>
struct Geo {
  static constexpr int kCpr = 128 / CB;             // codes a storage row
  static constexpr int kRows = kTile / kCpr;        // storage rows a tile
  static constexpr int kCodeBytes = 32 * CB;        // one code's one-hot
  static constexpr int kStageBytes = kTile * kCodeBytes;
  static constexpr int kStages = CB == 8 ? 3 : 2;   // 96 KB or 128 KB of one-hot
};

// `threads`: how many arrive at or wait on the barrier in all.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo` bytes
// apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 128, int32) = or += a (64 x 32 int8, registers) x b (32 x 128, shared memory).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Thread p of the producer: the one-hot of code p of the tile at `code`
// (CB bytes) into `stage`.
template <int CB>
__device__ __forceinline__ void write_onehot(unsigned char* stage, int p, const uint32_t (&w)[CB / 4]) {
  uint4* core = reinterpret_cast<uint4*>(stage) + (p >> 3) * (2 * CB) * 8 + (p & 7);
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xFFu;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t v = half ? byte >> 4 : byte & 15u;  // the entry of sub-quantizer 2b + half
      const uint32_t one = 1u << (8 * (v & 3u));
      const uint32_t word = v >> 2;
      core[(2 * b + half) * 8] = make_uint4(word == 0 ? one : 0u, word == 1 ? one : 0u,
                                            word == 2 ? one : 0u, word == 3 ? one : 0u);
    }
  }
}

// Two or four values as one aligned vector store.
__device__ __forceinline__ void store_vec(int32_t* dst, const int (&v)[2]) {
  *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(int32_t* dst, const int (&v)[4]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

template <int CB, bool kWithRows, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
flat_scan_wgmma_kernel(const uint8_t* __restrict__ codes,   // (R, 128)
                       const int8_t* __restrict__ tables,   // (Q, 2*CB, 16)
                       int32_t* __restrict__ out,           // (Q, R)
                       int32_t* __restrict__ rows_out,      // (Q, R), kWithRows only
                       int r_count, int q_count, int n) {
  using G = Geo<CB>;
  extern __shared__ __align__(128) unsigned char ring[];  // kStages stages of one-hot
  const int group = threadIdx.x >> 7;  // 0, 1: consumers; 2: the producer
  const int tiles = (r_count + G::kRows - 1) / G::kRows;

  if (group == 2) {
    const int p = threadIdx.x & 127;
    // The bytes of code p of a tile; a code past the last storage row reads zeros.
    auto load = [&](int tile, uint32_t (&w)[CB / 4]) {
#pragma unroll
      for (int i = 0; i < CB / 4; ++i) w[i] = 0u;
      const size_t code = static_cast<size_t>(tile) * kTile + p;
      if ((MODE & kExpand) != 0 && tile < tiles && code < static_cast<size_t>(r_count) * G::kCpr) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(codes + code * CB);
#pragma unroll
        for (int i = 0; i < CB / 4; ++i) w[i] = __ldg(src + i);
      }
    };
    uint32_t w[CB / 4], ahead[CB / 4];  // this tile's code and the next tile's, on its way
    load(blockIdx.x, ahead);
    int round = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
      const int stage = round % G::kStages;
#pragma unroll
      for (int i = 0; i < CB / 4; ++i) w[i] = ahead[i];
      load(tile + gridDim.x, ahead);
      if (round >= G::kStages) bar_sync(empty_barrier(stage), kThreads);  // both groups are done
      if constexpr ((MODE & kExpand) != 0) write_onehot<CB>(ring + stage * G::kStageBytes, p, w);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(full_barrier(stage, 0), 256);
      bar_arrive(full_barrier(stage, 1), 256);
    }
    return;
  }

  // Consumers: warp w of the group holds queries q0 + 16w + g and + 8.
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * 128 + group * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const int q_lo = q0 + g, q_hi = q0 + g + 8;
  uint32_t a[CB][4];
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(tables + static_cast<size_t>(min(q_lo, q_count - 1)) * (32 * CB));
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(tables + static_cast<size_t>(min(q_hi, q_count - 1)) * (32 * CB));
    a[b][0] = q_lo < q_count ? __ldg(lo + 8 * b + t) : 0u;
    a[b][1] = q_hi < q_count ? __ldg(hi + 8 * b + t) : 0u;
    a[b][2] = q_lo < q_count ? __ldg(lo + 8 * b + 4 + t) : 0u;
    a[b][3] = q_hi < q_count ? __ldg(hi + 8 * b + 4 + t) : 0u;
  }

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  constexpr int kKeep = G::kRows / 4;  // rows a lane stores: rows kKeep*t .. of the tile
  if (group == 1) bar_arrive(turn_barrier(0), 256);  // group 0 has the first turn
  int round = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    const int stage = round % G::kStages;
    bar_sync(full_barrier(stage, group), 256);  // the producer has filled the stage
    bar_sync(turn_barrier(group), 256);         // the other group has started its products
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const unsigned char* base = ring + stage * G::kStageBytes;
    if constexpr ((MODE & kMma) != 0) {
#pragma unroll
      for (int b = 0; b < CB; ++b)  // k-step b: sub-quantizers 2b and 2b + 1 of every code
        wgmma_m64n128k32(d, a[b], smem_desc(base + (2 * b) * 128, 128, 2 * CB * 128), b > 0);
    } else {  // the lab, no products: values that depend on the stage and the tables
      const uint32_t seen = reinterpret_cast<const uint32_t*>(base)[threadIdx.x] ^ a[0][0];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = static_cast<int>(seen ^ (0x9E3779B1u * (i + 1)));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    bar_arrive(turn_barrier(1 - group), 256);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
    bar_arrive(empty_barrier(stage), kThreads);  // this group is done with the stage

    // d[4*nb + i]: query g + 8*(i >> 1), code 8*nb + 2t + (i & 1) of the tile.
    const int row0 = tile * G::kRows;
    const int real0 = n - row0 * G::kCpr;  // real codes from the tile's first on
    int keep[2][kKeep];
#pragma unroll
    for (int r = 0; r < G::kRows; ++r) {
      const int real = real0 - r * G::kCpr;  // real codes of storage row r
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = (MODE & kMin) != 0 ? INT_MAX : 0;
#pragma unroll
        for (int k = 0; k < G::kCpr / 8; ++k)
#pragma unroll
          for (int ci = 0; ci < 2; ++ci) {
            const int pos = 8 * k + 2 * t + ci;  // the code's position in its row
            int x = d[4 * (r * (G::kCpr / 8) + k) + 2 * h + ci];
            if constexpr ((MODE & kMin) == 0) {  // the lab, no minimum: any value of all four
              m ^= x;
              continue;
            }
            if constexpr (kWithRows) x = (x << 4) | pos;
            if (real < G::kCpr && pos >= real) x = INT_MAX;  // a padded code
            m = min(m, x);
          }
        if constexpr ((MODE & kMin) != 0) {
          m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 1));
          m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, 2));
        }
        if (r / kKeep == t) keep[h][r % kKeep] = m;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = h ? q_hi : q_lo;
      const int row = row0 + kKeep * t;  // lane t stores kKeep rows from here
      if (q >= q_count || row >= r_count) continue;
      const size_t o = static_cast<size_t>(q) * r_count + row;
      int v[kKeep], id[kKeep];
#pragma unroll
      for (int e = 0; e < kKeep; ++e) {
        const int x = keep[h][e];
        v[e] = x == INT_MAX ? kTrim : (kWithRows ? x >> 4 : x);
        id[e] = x == INT_MAX ? -1 : (row + e) * G::kCpr + (x & 15);
      }
      if (row + kKeep <= r_count && o % kKeep == 0) {  // aligned: one vector store
        store_vec(out + o, v);
        if constexpr (kWithRows) store_vec(rows_out + o, id);
      } else {
#pragma unroll
        for (int e = 0; e < kKeep; ++e) {
          if (row + e >= r_count) break;
          out[o + e] = v[e];
          if constexpr (kWithRows) rows_out[o + e] = id[e];
        }
      }
    }
  }
}

template <int CB, bool kWithRows, int MODE = kFull>
cudaError_t launch(const void* codes, const void* tables, void* out, void* rows_out, int r_count,
                   int q_count, int n, cudaStream_t stream) {
  using G = Geo<CB>;
  auto kernel = flat_scan_wgmma_kernel<CB, kWithRows, MODE>;
  constexpr int kSmem = G::kStages * G::kStageBytes;
  static int sms = 0;  // asked once for each instantiation
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    sms = count > 0 ? count : 1;
  }
  const int tiles = (r_count + G::kRows - 1) / G::kRows;
  const int q_groups = (q_count + 127) / 128;
  const int gx = sms / q_groups < 1 ? 1 : (sms / q_groups > tiles ? tiles : sms / q_groups);
  kernel<<<dim3(gx, q_groups), kThreads, kSmem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<int32_t*>(out), static_cast<int32_t*>(rows_out), r_count, q_count, n);
  return cudaGetLastError();
}


// The window scan's epilogue for one tile at W' = 2^LW (LW = 8: any W' > 128,
// whose minimum carries over the window's tiles in run[]). d holds the tile's
// sums, d[4*nb + 2h + ci] for query row h (g, g + 8) and column 8*nb + 2t + ci,
// and becomes their keys in place; live marks the tile's real columns. Each
// W' is its own instantiation: the kernel picks one a tile with a uniform
// switch, so the unrolled code holds only what that W' needs. From W' = 8 on,
// a run's minimum is taken over its groups of accumulators in registers and
// then reduced and scattered over the row's four lanes: lane t ends with the
// tile's windows t*V/4 .. (V = 128 / W'), so every lane stores and the
// stores are few. (This kernel's first form, with a runtime W' and a store
// site for every window, took 0.370 ms against flat_scan_wgmma_kernel's
// 0.070 at W = cpr, 1M codes and 128 queries, on an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py.)
template <int CB, bool kRows, int LW>
__device__ __forceinline__ void window_epilogue(int (&d)[64], const uint32_t (&live)[4],
                                                uint32_t gc0, int t, const int (&q)[2],
                                                int (&run)[2], bool first, bool last,
                                                int32_t* __restrict__ out,
                                                int32_t* __restrict__ rows_out,
                                                const qadc::WindowColumns& map, int q_count,
                                                int c_total, int transposed) {
  const uint32_t lw = LW == 8 ? map.lw : LW;
  if constexpr (kRows) {  // key = sum * 2^lw + the column's rank in its window
    const uint32_t r0 = (LW == 8 ? gc0 & ((1u << lw) - 1u) : 0u) + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t rank = (r0 + 8 * nb + (i & 1)) & ((LW == 8 ? 0u : (1u << LW)) - 1u);
        d[4 * nb + i] = static_cast<int>((static_cast<uint32_t>(d[4 * nb + i]) << lw) | rank);
      }
  }
  if ((live[0] & live[1] & live[2] & live[3]) != 0xFFFFFFFFu) {  // padded or dead columns
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i)  // column 8*nb + 2t + (i & 1): word nb / 4 of the mask
        if (!((live[nb >> 2] >> (8 * (nb & 3) + 2 * t + (i & 1))) & 1u)) d[4 * nb + i] = INT_MAX;
  }
  if constexpr (LW == 0) {  // W' = 1: every column is a window
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t gc = gc0 + 8 * nb + 2 * t + (i & 1);
        if (q[i >> 1] < q_count && gc < map.total)
          qadc::store_window<CB, kRows>(out, rows_out, map, d[4 * nb + i], gc, q[i >> 1],
                                        q_count, c_total, transposed);
      }
    return;
  }
  constexpr int S = LW <= 3 ? 1 : (LW >= 7 ? 16 : 1 << (LW - 3));  // accumulators a group
  constexpr int V = 16 / S;  // W' >= 8: windows a tile row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int v[16];  // the minimum of a lane's column pair, then of its group
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) v[nb] = min(d[4 * nb + 2 * h], d[4 * nb + 2 * h + 1]);
    const bool real_q = q[h] < q_count;
    if constexpr (LW <= 2) {  // W' = 2: a lane's pair; W' = 4: and its neighbour's
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        if (LW == 2) v[nb] = min(v[nb], __shfl_xor_sync(0xFFFFFFFFu, v[nb], 1));
        const uint32_t col0 = 8 * nb + 2 * t;
        if ((LW == 1 || (t & 1) == 0) && real_q && gc0 + col0 < map.total)
          qadc::store_window<CB, kRows>(out, rows_out, map, v[nb], (gc0 + col0) >> LW, q[h],
                                        q_count, c_total, transposed);
      }
      continue;
    }
#pragma unroll
    for (int s = 1; s < S; s <<= 1)
#pragma unroll
      for (int nb = 0; nb < 16; nb += 2 * s) v[nb] = min(v[nb], v[nb + s]);
    int w[V];  // window k of the tile row: group k
#pragma unroll
    for (int k = 0; k < V; ++k) w[k] = v[k * S];
    const bool hi = (t & 2) != 0, odd = (t & 1) != 0;
    if constexpr (V >= 2) {  // lanes t and t ^ 2 keep halves: windows hi * V/2 ..
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const int send = hi ? w[i] : w[V / 2 + i];
        w[i] = min(hi ? w[V / 2 + i] : w[i], __shfl_xor_sync(0xFFFFFFFFu, send, 2));
      }
    } else {
      w[0] = min(w[0], __shfl_xor_sync(0xFFFFFFFFu, w[0], 2));
    }
    if constexpr (V >= 4) {  // and t, t ^ 1 quarters: lane t has windows t * V/4 ..
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const int send = odd ? w[i] : w[V / 4 + i];
        w[i] = min(odd ? w[V / 4 + i] : w[i], __shfl_xor_sync(0xFFFFFFFFu, send, 1));
      }
      const uint32_t win0 = (gc0 >> LW) + t * (V / 4);
      const bool whole = win0 + V / 4 <= static_cast<uint32_t>(c_total);
      if (real_q) {
        if (!kRows && transposed && whole && V / 4 == 4 && win0 % 4 == 0 && c_total % 4 == 0) {
          *reinterpret_cast<int4*>(out + static_cast<size_t>(q[h]) * c_total + win0) =
              make_int4(w[0] == INT_MAX ? 1 << 30 : w[0], w[1] == INT_MAX ? 1 << 30 : w[1],
                        w[2] == INT_MAX ? 1 << 30 : w[2], w[3] == INT_MAX ? 1 << 30 : w[3]);
        } else if (!kRows && transposed && whole && V / 4 == 2 && c_total % 2 == 0) {
          *reinterpret_cast<int2*>(out + static_cast<size_t>(q[h]) * c_total + win0) =
              make_int2(w[0] == INT_MAX ? 1 << 30 : w[0], w[1] == INT_MAX ? 1 << 30 : w[1]);
        } else {
#pragma unroll
          for (int i = 0; i < V / 4; ++i)
            if (win0 + i < static_cast<uint32_t>(c_total))
              qadc::store_window<CB, kRows>(out, rows_out, map, w[i], win0 + i, q[h], q_count,
                                            c_total, transposed);
        }
      }
      continue;
    }
    w[0] = min(w[0], __shfl_xor_sync(0xFFFFFFFFu, w[0], 1));  // W' >= 64: the pair's window
    if constexpr (LW == 8) {  // W' > 128: one window over its tiles
      run[h] = first ? w[0] : min(run[h], w[0]);
      if (last && t == 0 && real_q)
        qadc::store_window<CB, kRows>(out, rows_out, map, run[h], gc0 >> lw, q[h], q_count,
                                      c_total, transposed);
      continue;
    }
    const uint32_t win = (gc0 >> LW) + (V == 2 && hi ? 1 : 0);  // W' = 64: windows by t & 2
    if (!odd && (V == 2 || t == 0) && real_q && win < static_cast<uint32_t>(c_total))
      qadc::store_window<CB, kRows>(out, rows_out, map, w[0], win, q[h], q_count, c_total,
                                    transposed);
  }
}

// Kernels 8, 8v and 8w with int8 tables on the same warpgroup product:
// replaces qadc_tpu/kernels/lut_scan.py:lut_scan_reduce at any block_n and
// window (minima, transposed minima, or with the argmin's code id; ties to
// the lowest slot) and with it lut_scan_topk_int8, at any batch (queries
// past q_count in a group of 128 are masked). What
// bounds it on the H100 is flat_scan_wgmma_kernel's pipeline (the one-hot,
// the products, the minima), with the C x Q minima to write (32 MB at W = 16
// over 1M codes and 128 queries, 64 MB at W = 8). The producer's thread p takes column
// p of a tile in the window-major order of window_columns.cuh (a gather: at
// W = cpr a tile is 128 consecutive codes, at W = 8 and cpr = 16 the codes of
// one parity of 16 storage rows) and marks the tile's real columns in a
// 128-bit mask beside the stage. Consumers take, per query, the minimum key
// (column_key) over each run of W' columns (window_epilogue): min over a
// lane's column pair, over groups of W'/8 accumulators in registers, then
// xor-shuffles over the four lanes of a row; a window longer than a tile
// (W' > 128) carries its minimum over its W'/128 consecutive tiles, which
// one block takes in turn.
template <int CB, bool kWithRows>
__global__ void __launch_bounds__(kThreads, 1)
flat_scan_window_wgmma_kernel(const uint8_t* __restrict__ codes,   // (N_pad / cpr, 128)
                              const int8_t* __restrict__ tables,   // (Q, 2*CB, 16)
                              int32_t* __restrict__ out,           // (C, Q) or (Q, C)
                              int32_t* __restrict__ rows_out,      // (C, Q), kWithRows only
                              qadc::WindowColumns map, int units, int span, int c_total,
                              int q_count, int n, int transposed) {
  using G = Geo<CB>;
  // kStages stages of one-hot, then each stage's mask of real columns.
  extern __shared__ __align__(128) unsigned char ring[];
  auto s_live = reinterpret_cast<uint32_t (*)[kTile / 32]>(ring + G::kStages * G::kStageBytes);
  const int group = threadIdx.x >> 7;  // 0, 1: consumers; 2: the producer
  // The block takes units blockIdx.x, + gridDim.x, .., each `span` consecutive tiles.
  const int count = blockIdx.x < units ? ((units - 1 - blockIdx.x) / gridDim.x + 1) * span : 0;

  if (group == 2) {
    const int p = threadIdx.x & 127;
    qadc::UnitWalk ahead_walk(blockIdx.x, span, gridDim.x);
    // Column p of the block's j-th tile: its code and the code's bytes (zeros for none).
    auto load = [&](int j, uint32_t (&w)[CB / 4]) {
#pragma unroll
      for (int i = 0; i < CB / 4; ++i) w[i] = 0u;
      const int code = j < count ? qadc::column_code<CB>(map, ahead_walk.tile * kTile + p) : -1;
      ahead_walk.next();
      if (code >= 0) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(codes + static_cast<size_t>(code) * CB);
#pragma unroll
        for (int i = 0; i < CB / 4; ++i) w[i] = __ldg(src + i);
      }
      return code;
    };
    uint32_t w[CB / 4], ahead[CB / 4];
    int code_ahead = load(0, ahead);
    for (int j = 0; j < count; ++j) {
      const int stage = j % G::kStages;
      const int code = code_ahead;
#pragma unroll
      for (int i = 0; i < CB / 4; ++i) w[i] = ahead[i];
      code_ahead = load(j + 1, ahead);
      const unsigned live = __ballot_sync(0xFFFFFFFFu, code >= 0 && code < n);
      if (j >= G::kStages) bar_sync(empty_barrier(stage), kThreads);  // both groups are done
      write_onehot<CB>(ring + stage * G::kStageBytes, p, w);
      if ((p & 31) == 0) s_live[stage][p >> 5] = live;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(full_barrier(stage, 0), 256);
      bar_arrive(full_barrier(stage, 1), 256);
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * 128 + group * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const int q[2] = {q0 + g, q0 + g + 8};
  uint32_t a[CB][4];
#pragma unroll
  for (int b = 0; b < CB; ++b) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(tables + static_cast<size_t>(min(q[0], q_count - 1)) * (32 * CB));
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(tables + static_cast<size_t>(min(q[1], q_count - 1)) * (32 * CB));
    a[b][0] = q[0] < q_count ? __ldg(lo + 8 * b + t) : 0u;
    a[b][1] = q[1] < q_count ? __ldg(hi + 8 * b + t) : 0u;
    a[b][2] = q[0] < q_count ? __ldg(lo + 8 * b + 4 + t) : 0u;
    a[b][3] = q[1] < q_count ? __ldg(hi + 8 * b + 4 + t) : 0u;
  }

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  int run[2] = {INT_MAX, INT_MAX};  // W' > 128: the window's minimum over its tiles so far
  qadc::UnitWalk walk(blockIdx.x, span, gridDim.x);
  if (group == 1) bar_arrive(turn_barrier(0), 256);  // group 0 has the first turn
  for (int j = 0; j < count; ++j, walk.next()) {
    const int stage = j % G::kStages;
    bar_sync(full_barrier(stage, group), 256);  // the producer has filled the stage
    bar_sync(turn_barrier(group), 256);         // the other group has started its products
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const unsigned char* base = ring + stage * G::kStageBytes;
#pragma unroll
    for (int b = 0; b < CB; ++b)  // k-step b: sub-quantizers 2b and 2b + 1 of every column
      wgmma_m64n128k32(d, a[b], smem_desc(base + (2 * b) * 128, 128, 2 * CB * 128), b > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    bar_arrive(turn_barrier(1 - group), 256);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
    uint32_t live[kTile / 32];
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) live[i] = s_live[stage][i];
    bar_arrive(empty_barrier(stage), kThreads);  // this group is done with the stage

    const uint32_t gc0 = static_cast<uint32_t>(walk.tile) * kTile;
    const bool first = walk.k == 0, last = walk.k == span - 1;
#define QADC_WINDOW_EPILOGUE(LW)                                                              \
  window_epilogue<CB, kWithRows, LW>(d, live, gc0, t, q, run, first, last, out, rows_out, map, \
                                     q_count, c_total, transposed)
    switch (map.lw) {  // the same for the whole grid
      case 0: QADC_WINDOW_EPILOGUE(0); break;
      case 1: QADC_WINDOW_EPILOGUE(1); break;
      case 2: QADC_WINDOW_EPILOGUE(2); break;
      case 3: QADC_WINDOW_EPILOGUE(3); break;
      case 4: QADC_WINDOW_EPILOGUE(4); break;
      case 5: QADC_WINDOW_EPILOGUE(5); break;
      case 6: QADC_WINDOW_EPILOGUE(6); break;
      case 7: QADC_WINDOW_EPILOGUE(7); break;
      default: QADC_WINDOW_EPILOGUE(8); break;
    }
#undef QADC_WINDOW_EPILOGUE
  }
}

template <int CB, bool kWithRows>
cudaError_t launch_window(const void* codes, const void* tables, void* out, void* rows_out,
                          int n_pad, int q_count, int n, int block_n, int window,
                          int transposed, cudaStream_t stream) {
  using G = Geo<CB>;
  auto kernel = flat_scan_window_wgmma_kernel<CB, kWithRows>;
  constexpr int kSmem = G::kStages * G::kStageBytes + G::kStages * kTile / 8;
  static int sms = 0;  // asked once for each instantiation
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    sms = count > 0 ? count : 1;
  }
  const qadc::WindowColumns map = qadc::make_window_columns(n_pad, block_n, window, CB);
  const int c_total = n_pad / window;
  // A unit is the tiles that end a set of windows: one tile, or a window's W'/128.
  const int span = (1 << map.lw) > kTile ? (1 << map.lw) / kTile : 1;
  const int units = span > 1 ? c_total : static_cast<int>((map.total + kTile - 1) / kTile);
  const int q_groups = (q_count + 127) / 128;
  const int gx = sms / q_groups < 1 ? 1 : (sms / q_groups > units ? units : sms / q_groups);
  kernel<<<dim3(gx, q_groups), kThreads, kSmem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(tables),
      static_cast<int32_t*>(out), static_cast<int32_t*>(rows_out), map, units, span, c_total,
      q_count, n, transposed);
  return cudaGetLastError();
}

}  // namespace

// int8 tables, int32 out (Q, R); rows_out (Q, R) may be null (minima only).
// n: real code count, 0 <= n <= r_count * cpr.
extern "C" int qadc_flat_scan_wgmma(const void* codes, const void* tables, void* out,
                                    void* rows_out, int r_count, int q_count, int n, int cb,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && rows_out) return launch<8, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 8) return launch<8, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  if (cb == 16 && rows_out) return launch<16, true>(codes, tables, out, rows_out, r_count, q_count, n, s);
  if (cb == 16) return launch<16, false>(codes, tables, out, nullptr, r_count, q_count, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernels 8, 8v, 8w with int8 tables: int32 minima (N_pad / window, Q), or
// (Q, N_pad / window) with transpose_out; rows_out (N_pad / window, Q) may be
// null (minima only) and excludes transpose_out. n: real code count.
extern "C" int qadc_flat_scan_window_wgmma(const void* codes, const void* tables, void* out,
                                           void* rows_out, int n_pad, int q_count, int n,
                                           int block_n, int window, int cb, int transpose_out,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || n_pad < 1 || block_n < 1 || window < 1 || n_pad % block_n != 0
      || block_n % window != 0 || (cb != 8 && cb != 16) || block_n % (128 / cb) != 0
      || (rows_out && transpose_out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cb == 8 && rows_out)
    return launch_window<8, true>(codes, tables, out, rows_out, n_pad, q_count, n, block_n,
                                  window, 0, s);
  if (cb == 8)
    return launch_window<8, false>(codes, tables, out, nullptr, n_pad, q_count, n, block_n,
                                   window, transpose_out, s);
  if (rows_out)
    return launch_window<16, true>(codes, tables, out, rows_out, n_pad, q_count, n, block_n,
                                   window, 0, s);
  return launch_window<16, false>(codes, tables, out, nullptr, n_pad, q_count, n, block_n,
                                  window, transpose_out, s);
}

// The scan lab's view of the kernel (scan_lab.cu): CB = 8, minima only, with
// parts removed. mode: the parts kept, expand 1 | products 2 | minima 4; only
// mode 7's output is the scan's.
extern "C" int qadc_scan_lab_wgmma(const void* codes, const void* tables, void* out, int r_count,
                                   int q_count, int n, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_count < 1 || r_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0: return launch<8, false, 0>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 1: return launch<8, false, 1>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 2: return launch<8, false, 2>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 4: return launch<8, false, 4>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 3: return launch<8, false, 3>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 5: return launch<8, false, 5>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 6: return launch<8, false, 6>(codes, tables, out, nullptr, r_count, q_count, n, s);
    case 7: return launch<8, false, 7>(codes, tables, out, nullptr, r_count, q_count, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
