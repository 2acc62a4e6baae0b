// What the slot-minor grouped scans (grouped_scan_sm.cu: M1 with float32
// tables; grouped_scan8_sm.cu: kernels 5 + 6) share: the persistent walk over
// (slot window, group, tile) items and the batched check of their live slots.
//
// A group's G slots hold (query, probe) pair ids, -1 when empty; routing fills
// them as a prefix, about 4 of G = 128 at IVF-256, ma=24, b=32 and 13 at
// b=128. The lookup kernels these replaced launched a block per (group,
// tile, chunk of slots sized for all G) and most of them found no live slot;
// a live block ran its slots one after another, so a group of many live
// slots was one long block. Here the unit of work is
// an item: a window of kSlots = 4 consecutive slots of a group over a tile of
// 128 of its storage rows, one row a thread and all 4 slots in the thread. A
// persistent grid walks the items; a block checks kBatch of them in one round
// trip (check_items: a thread loads one item's 4 pair ids) and works only on
// those with a live slot, so a dead window costs a share of
// one load, and a group of 128 live slots is 32 items that run side by side.
// The live counts stay on the device: the host never learns them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "flat_scan_qm.cuh"  // QmMode (lab modes), sm_count

namespace qadc {

constexpr int kSmThreads = 128;      // a thread is a storage row
constexpr int kSmTile = kSmThreads;  // storage rows of an item
constexpr int kSlots = 4;            // slots of a window, all in each thread
constexpr int kBatch = kSmThreads;   // items a block checks at once: one a thread

// Item i is slot window w (slots [4w, 4w + 4)) of group g over tile t;
// window-major, so the first windows, where routing puts the live slots, come
// first and spread over every block.
struct Item {
  int g, w, t;
};
__device__ __forceinline__ Item decode_item(long long item, int gcap, int tiles) {
  const int t = static_cast<int>(item % tiles);
  const long long gw = item / tiles;
  return {static_cast<int>(gw % gcap), static_cast<int>(gw / gcap), t};
}

__host__ __device__ inline long long item_count(int gcap, int group_size, int tiles) {
  return static_cast<long long>((group_size + kSlots - 1) / kSlots) * gcap * tiles;
}

// The live items of a block's batch, in item order.
struct ItemBatch {
  int count;
  int warp_live[kSmThreads / 32];
  int tile[kBatch];
  int part[kBatch];             // the group's partition
  int size[kBatch];             // and its real code count
  int n[kBatch];                // live slots of the window, 1 to 4
  int32_t ids[kBatch][kSlots];  // their pair ids, in slot order
};

// Checks items item0 + j * gridDim.x, j < kBatch (thread j: the window's 4
// pair ids and its group's partition and size, one round trip), and lists
// the live ones in b. Begins with a barrier (the last batch is read) and ends
// with one.
__device__ __forceinline__ void check_items(const int32_t* __restrict__ slot_pair,
                                            const int32_t* __restrict__ group_part,
                                            const int32_t* __restrict__ group_sizes,
                                            int group_size, long long item0, long long items,
                                            int gcap, int tiles, ItemBatch& b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = item0 + static_cast<long long>(threadIdx.x) * gridDim.x;
  int32_t ids[kSlots] = {-1, -1, -1, -1};
  int n = 0, part = 0, size = 0;
  Item it{0, 0, 0};
  if (item < items) {
    it = decode_item(item, gcap, tiles);
    const int32_t* row = slot_pair + static_cast<size_t>(it.g) * group_size + it.w * kSlots;
    int32_t p[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) p[s] = it.w * kSlots + s < group_size ? row[s] : -1;
    part = group_part[it.g];
    size = group_sizes[it.g];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // compact, in slot order
      if (p[s] >= 0) {
#pragma unroll
        for (int d = 0; d < kSlots; ++d)
          if (d == n) ids[d] = p[s];
        ++n;
      }
    }
  }
  const unsigned live = __ballot_sync(0xffffffffu, n > 0);
  __syncthreads();  // the last batch is read
  if (lane == 0) b.warp_live[warp] = __popc(live);
  __syncthreads();
  int at = __popc(live & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) at += b.warp_live[w];
  if (n > 0) {
    b.tile[at] = it.t;
    b.part[at] = part;
    b.size[at] = size;
    b.n[at] = n;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) b.ids[at][s] = ids[s];
  }
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kSmThreads / 32; ++w) total += b.warp_live[w];
    b.count = total;
  }
  __syncthreads();
}

// Blocks of a persistent grid of `kernel` at kSmThreads threads and `smem`
// bytes: as many as the SMs hold at once (the live items spread over all of
// them), and no more than the items.
template <typename K>
inline int persistent_blocks(K kernel, size_t smem, long long items) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmThreads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long blocks = static_cast<long long>(per_sm) * sm_count();
  return static_cast<int>(items < blocks ? (items > 0 ? items : 1) : blocks);
}

}  // namespace qadc
