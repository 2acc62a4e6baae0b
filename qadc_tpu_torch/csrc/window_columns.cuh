// Window-major columns: the order in which the tensor-core window scan
// (flat_scan_window_wgmma_kernel in scan_wgmma.cu) lays a block's codes out as
// the product's columns, so that every window of lut_scan_reduce is a run of
// adjacent columns.
//
// Window g of a block of block_n codes holds slots {g, g + G, ..., g + (W-1)G}
// (G = block_n / W), and slot s = c*R + r is the code at in-block position
// r*cpr + c (R = block_n / cpr storage rows a block). Each window takes W' =
// the power of two at or above W columns: column g*W' + k holds slot g + k*G
// for k < W, and nothing (a dead column) for W <= k < W'. Over the whole
// scan, column gc is rank gc % W' of window gc / W', so a window's minimum is
// the minimum over a run of W' columns, aligned at a multiple of W', and the
// rank of its minimum is its slot's rank: the lowest tied slot is the lowest
// tied rank. At W = cpr the order is the storage order (window g is storage
// row g). lut_scan.window_column_codes is this map in PyTorch.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qadc {

// x / d for 0 <= x < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method): s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1,
// and x / d = (umulhi(x, m) + x) >> s; the sum stays below 2^32.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t x) const { return (__umulhi(x, m) + x) >> s; }
};

inline FastDiv make_fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(m), s};
}

struct WindowColumns {
  uint32_t lw;       // log2 W'
  uint32_t window;   // W
  uint32_t block_n;
  uint32_t total;    // C * W' columns: C = N_pad / W windows
  FastDiv groups;    // G = block_n / W
  FastDiv rows;      // R = block_n / cpr
};

inline WindowColumns make_window_columns(int n_pad, int block_n, int window, int cb) {
  uint32_t lw = 0;
  while ((1u << lw) < static_cast<uint32_t>(window)) ++lw;
  return WindowColumns{lw, static_cast<uint32_t>(window), static_cast<uint32_t>(block_n),
                       static_cast<uint32_t>(n_pad / window) << lw,
                       make_fast_div(static_cast<uint32_t>(block_n / window)),
                       make_fast_div(static_cast<uint32_t>(block_n / (128 / cb)))};
}

// The code id in column gc, or -1 for a dead column or one past the last window.
template <int CB>
__device__ __forceinline__ int column_code(const WindowColumns& m, uint32_t gc) {
  if (gc >= m.total) return -1;
  const uint32_t win = gc >> m.lw;
  const uint32_t k = gc & ((1u << m.lw) - 1u);
  if (k >= m.window) return -1;
  const uint32_t blk = m.groups.div(win);
  const uint32_t slot = win - blk * m.groups.d + k * m.groups.d;  // g + k*G
  const uint32_t c = m.rows.div(slot);
  return static_cast<int>(blk * m.block_n + (slot - c * m.rows.d) * (128 / CB) + c);
}

// A column's key: its sum, and with kRows its rank in the window in the low
// lw bits (sum * 2^lw + rank, also for a negative sum), so the minimum key
// carries the lowest tied rank; INT_MAX for a column that is not a real code.
template <bool kRows>
__device__ __forceinline__ int column_key(int sum, bool live, uint32_t gc, uint32_t lw) {
  if (!live) return 0x7FFFFFFF;
  if constexpr (kRows)
    return static_cast<int>((static_cast<uint32_t>(sum) << lw) | (gc & ((1u << lw) - 1u)));
  return sum;
}

// Writes the minimum key x of window `win` for query q: the sum, or 1 << 30
// for a window with no real code; with kRows also the code id of the rank
// in x's low bits, -1 for such a window. out is (C, Q), or (Q, C) when
// transposed (minima only); rows_out is (C, Q).
template <int CB, bool kRows>
__device__ __forceinline__ void store_window(int32_t* __restrict__ out,
                                             int32_t* __restrict__ rows_out,
                                             const WindowColumns& m, int x, uint32_t win, int q,
                                             int q_count, int c_total, int transposed) {
  const bool none = x == 0x7FFFFFFF;
  const size_t o = transposed ? static_cast<size_t>(q) * c_total + win
                              : static_cast<size_t>(win) * q_count + q;
  out[o] = none ? (1 << 30) : (kRows ? (x >> m.lw) : x);
  if constexpr (kRows)
    rows_out[o] = none ? -1 : column_code<CB>(m, (win << m.lw) | (x & ((1 << m.lw) - 1)));
}

// A walk over units of `span` consecutive tiles: units first,
// first + stride, ...; tile is the current one, k its place in its unit.
struct UnitWalk {
  int tile, k, span, stride;
  __device__ __forceinline__ UnitWalk(int first, int span_, int stride_)
      : tile(first * span_), k(0), span(span_), stride(stride_) {}
  __device__ __forceinline__ void next() {
    if (++k == span) {
      k = 0;
      tile += (stride - 1) * span + 1;
    } else {
      ++tile;
    }
  }
};

}  // namespace qadc
