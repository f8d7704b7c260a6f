// Pieces shared by the tile kernels of csrc/*.cu: the multiprocessor
// count, the rows of a CSC's edge tiles (K1, K3 and the kernels that run
// K3's pass) and the tile states of a decoupled look-back (K7, K10).
//
// Each source that includes this header gets its own copy (an anonymous
// namespace), so the sources still compile and link one by one.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Multiprocessors of the current device, read once a device.
[[maybe_unused]] int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}

// tile_rows[t] = the row that holds CSC edge t * kTileEdges, written by
// that row (each nonempty row writes the tiles whose first edge it
// holds); tile_rows[ntiles] = rows. One thread a row, grid-stride: a
// V-wide pass over csc_offsets (merge-based SpMV's partition, Merrill
// and Garland, SC16). A tile then finds the rows that start inside it
// by reading csc_offsets over tile_rows[t] + 1 .. tile_rows[t + 1], so
// no per-edge row array is read. Off is the offsets' type: int32_t, or
// int64_t for a graph past 2^31 edges (rows and tiles stay int32: fewer
// than 2^31 rows, and 2^20 tiles of 2048 edges at 2^31 edges).
template <int kTileEdges, typename Off = int32_t>
__global__ void csc_tile_rows_kernel(const Off* __restrict__ offsets,
                                     int64_t rows, int64_t num_edges,
                                     int32_t* __restrict__ tile_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < rows;
       v += stride) {
    const int64_t lo = __ldg(offsets + v);
    const int64_t hi = __ldg(offsets + v + 1);
    for (int64_t t = (lo + kTileEdges - 1) / kTileEdges; t * kTileEdges < hi;
         ++t) {
      tile_rows[t] = (int32_t)v;
    }
    if (v == 0) {
      tile_rows[(num_edges + kTileEdges - 1) / kTileEdges] = (int32_t)rows;
    }
  }
}

// Tile states of a decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016): one 64-bit word
// a field, its high half the flag (kReady: the tile's own count;
// kInclusive: the count of every tile up to it), its low half the value,
// so a field and its flag arrive together. The caller zeroes the words
// before the launch. Tiles are taken from a counter, so every tile a
// wait names is held by a running block or warp and the wait ends.
constexpr uint64_t kReady = 1ull << 32, kInclusive = 2ull << 32;

__device__ __forceinline__ void store_word(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A field of an earlier tile, once written. A wait that lasts seconds is
// a fault and traps (the launch then fails) instead of holding the card.
__device__ __forceinline__ uint64_t wait_word(const uint64_t* p) {
  uint64_t v;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    if ((v >> 32) != 0) return v;
    if (spins == (1u << 24)) __trap();
  }
}

// The exclusive prefix of tile c's count, by one warp: the counts of
// tiles c - 1, c - 2, ... (tile j's word at counts[stride * j]) added 32
// at a step, up to the nearest tile that has published its inclusive
// prefix. Integers, so the order of the additions does not matter. The
// same value in every lane.
__device__ __forceinline__ int64_t warp_lookback(const uint64_t* counts,
                                                 int64_t stride, int64_t c,
                                                 int lane) {
  int64_t excl = 0;
  for (int64_t base = c - 1;; base -= 32) {
    const int64_t j = base - lane;
    const uint64_t w = j >= 0 ? wait_word(counts + stride * j) : kInclusive;
    const unsigned incl = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int64_t v = lane <= stop ? (int64_t)(uint32_t)w : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (incl) return excl;
  }
}

}  // namespace
