// Hopper (sm_90a) kernels of the DO-BFS path, behind a plain C interface
// that gunrock_tpu_torch/ops/kernels.py loads with ctypes.
//
// Build (gunrock_tpu_torch/ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libkernels.so bfs_kernels.cu
//
// Packed bitmasks are int32 words on the Python side with bit 31 in use
// (bit v lives in word v >> 5 at position v & 31); the kernels read them
// as uint32 so that shifts are logical. A vertex id outside the mask
// (negative, or at least nbits) reads as 0, as it does in the TPU
// kernels, whose row loop never matches such an id.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is reported to the wrapper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

__device__ __forceinline__ uint32_t mask_bit(const uint32_t* __restrict__ words,
                                             uint64_t nbits, uint32_t u) {
  return (uint64_t)u < nbits ? (__ldg(words + (u >> 5)) >> (u & 31u)) & 1u
                             : 0u;
}

// K1: packed reach words of a full-edge pull over the CSC.
//
// Replaces the TPU kernels behind gunrock_tpu/ops/pallas_kernels.py
// pull_reached_words (:348): _pull_cells_kernel (:257) with its
// sample_sorted extraction (:594), and _blocked_pull_kernel (:166). Those
// stream a blocked, word-aligned edge layout through VMEM because the TPU
// has no fast random gather. Here the plain CSC is read directly.
//
// Bit v of out[w] (v = 32*w + b) is set iff some in-neighbour u of v has
// bit u set in `words`. `out` must be zeroed by the caller.
//
// Work is split by edges, not by vertices: each warp takes 32 consecutive
// CSC edges at a time (grid-stride), so an R-MAT hub's row of 10^5 edges
// is spread over thousands of warps instead of holding one. Lane l reads
// edge e = base + l: its source csc_indices[e] and destination
// csc_edge_dst[e], both coalesced, and tests the source's frontier bit.
// Destinations are nondecreasing along the CSC, so lanes that share a
// destination word are contiguous: a 5-step shuffle OR combines them and
// the first lane of each word issues one atomicOr. OR is idempotent and
// commutative, so the result does not depend on the order of the atomics.
//
// Bound on the H100: the 8 bytes an edge streamed from HBM (485 MB at
// rmat n20 e32, 0.145 ms at 3.35 TB/s). The frontier words are 128 KB at
// V = 2^20, so the random 4-byte reads of them hit L2.
__global__ void pull_reached_words_kernel(const uint32_t* __restrict__ words,
                                          uint64_t nbits,
                                          const int32_t* __restrict__ indices,
                                          const int32_t* __restrict__ edge_dst,
                                          int64_t num_edges,
                                          uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // base is uniform across the warp, so every lane reaches each shuffle.
  for (int64_t base = warp * 32; base < num_edges; base += nwarps * 32) {
    const int64_t e = base + lane;
    int32_t wid = -1;  // tail lanes: a key no destination word has
    uint32_t bit = 0;
    if (e < num_edges) {
      const int32_t v = __ldg(edge_dst + e);
      wid = v >> 5;
      if (mask_bit(words, nbits, (uint32_t)__ldg(indices + e))) {
        bit = 1u << (v & 31);
      }
    }
    // Segmented OR toward the first lane of each run of equal wid.
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t other_bit = __shfl_down_sync(0xffffffffu, bit, d);
      const int32_t other_wid = __shfl_down_sync(0xffffffffu, wid, d);
      if (lane + d < 32 && other_wid == wid) bit |= other_bit;
    }
    const int32_t prev_wid = __shfl_up_sync(0xffffffffu, wid, 1);
    if (wid >= 0 && bit != 0 && (lane == 0 || prev_wid != wid)) {
      atomicOr(out + wid, bit);
    }
  }
}

// K2: out[i] = bit idx[i] of a packed mask, as 0/1 int32.
//
// Replaces gunrock_tpu/ops/pallas_kernels.py _gather_kernel (:71) behind
// bitmask_gather (:116), which loops over the VMEM-resident table rows
// because a TPU core cannot gather across them. Here each thread reads
// its word directly; one thread per index over a grid-stride loop, with
// no length requirement. Bound: the idx read and out write stream at
// HBM bandwidth (8 bytes an index); the word reads hit L2.
__global__ void bitmask_gather_kernel(const uint32_t* __restrict__ words,
                                      uint64_t nbits,
                                      const int32_t* __restrict__ idx,
                                      int64_t n, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (int32_t)mask_bit(words, nbits, (uint32_t)idx[i]);
  }
}

// K10: out[i] = bit idx[0] + ... + bit idx[i] of a packed mask, an
// inclusive int32 running sum.
//
// Replaces gunrock_tpu/ops/pallas_kernels.py _gather_cumsum_kernel (:829)
// behind bitmask_gather_cumsum (:880). That kernel carries the running
// total from one grid step to the next in SMEM, which only works because a
// TPU runs its grid in order on one core. Here blocks run in no order, so
// the carry becomes three launches on one stream:
//
//   1. tile_counts: each block counts the hits of one tile of kTile
//      consecutive ids;
//   2. scan_tiles: one block turns the counts into exclusive tile offsets,
//      in place, looping over them 1024 at a time with a carry (about 15k
//      tiles at 60M edges);
//   3. gather_cumsum: each block gathers its tile's bits again, scans them
//      and adds its tile offset.
//
// Inside a tile, warp w's j-th load covers the 32 consecutive ids of group
// g = 8j + w (coalesced), and __ballot_sync turns their bits into one word:
// a lane's prefix within the group is a popcount of the word under its lane
// mask, and one warp scans the tile's 128 group counts. Sums are exact in
// int32: the wrapper's caller refuses graphs of 2^31 - 2 edges or more.
//
// Bound on the H100: the 4-byte id read and the 4-byte sum written, 8 bytes
// an id (0.145 ms over the 60.7M CSC sources at rmat n20 e32). This design
// reads the ids twice, 12 bytes an id; a single pass with a decoupled
// look-back would read them once.
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kTile = kScanThreads * kScanItems;  // 4096 ids a block
constexpr int kGroups = kTile / 32;               // 128 ballot words a tile
constexpr int kScanTileThreads = 1024;

__global__ void tile_counts_kernel(const uint32_t* __restrict__ words,
                                   uint64_t nbits,
                                   const int32_t* __restrict__ idx, int64_t n,
                                   int32_t* __restrict__ tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t e = base + (int64_t)j * kScanThreads + threadIdx.x;
    if (e < n) count += (int)mask_bit(words, nbits, (uint32_t)__ldg(idx + e));
  }
  for (int d = 16; d > 0; d >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, d);
  }
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) total += warp_sums[w];
    tiles[blockIdx.x] = total;
  }
}

__global__ void scan_tiles_kernel(int32_t* __restrict__ tiles,
                                  int64_t ntiles) {
  __shared__ int warp_tot[kScanTileThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;  // the same in every thread
  for (int64_t base = 0; base < ntiles; base += kScanTileThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < ntiles ? tiles[i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = warp_tot[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_tot[warp - 1] : 0;
    if (i < ntiles) tiles[i] = carry + before + x - v;
    carry += warp_tot[kScanTileThreads / 32 - 1];
    __syncthreads();  // warp_tot is written again in the next round
  }
}

__global__ void gather_cumsum_kernel(const uint32_t* __restrict__ words,
                                     uint64_t nbits,
                                     const int32_t* __restrict__ idx,
                                     int64_t n,
                                     const int32_t* __restrict__ tile_offsets,
                                     int32_t* __restrict__ out) {
  __shared__ int group_prefix[kGroups];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  uint32_t ballots[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t e = base + (int64_t)j * kScanThreads + threadIdx.x;
    const uint32_t hit =
        e < n ? mask_bit(words, nbits, (uint32_t)__ldg(idx + e)) : 0u;
    ballots[j] = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) group_prefix[j * (kScanThreads / 32) + warp] =
        __popc(ballots[j]);
  }
  __syncthreads();
  if (warp == 0) {
    // Lane l scans groups 4l .. 4l + 3, which follow each other in id order.
    int c[kGroups / 32];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kGroups / 32; ++k) {
      c[k] = group_prefix[lane * (kGroups / 32) + k];
      sum += c[k];
    }
    int x = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int k = 0; k < kGroups / 32; ++k) {
      group_prefix[lane * (kGroups / 32) + k] = run;
      run += c[k];
    }
  }
  __syncthreads();
  const int tile_off = tile_offsets[blockIdx.x];
  const uint32_t upto_lane = (2u << lane) - 1u;  // lanes 0..lane; all at 31
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t e = base + (int64_t)j * kScanThreads + threadIdx.x;
    if (e < n) {
      out[e] = tile_off + group_prefix[j * (kScanThreads / 32) + warp] +
               __popc(ballots[j] & upto_lane);
    }
  }
}

unsigned int blocks_for(int64_t threads) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int gr_pull_reached_words(const void* words, int64_t nbits,
                          const void* indices, const void* edge_dst,
                          int64_t num_edges, void* out, void* stream) {
  if (num_edges > 0) {
    pull_reached_words_kernel<<<blocks_for(num_edges), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)words, (uint64_t)nbits, (const int32_t*)indices,
        (const int32_t*)edge_dst, num_edges, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

int gr_bitmask_gather(const void* words, int64_t nbits, const void* idx,
                      int64_t n, void* out, void* stream) {
  if (n > 0) {
    bitmask_gather_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)words, (uint64_t)nbits, (const int32_t*)idx, n,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// `tiles` is scratch of `tile_capacity` int32, at least ceil(n / 4096).
int gr_bitmask_gather_cumsum(const void* words, int64_t nbits,
                             const void* idx, int64_t n, void* tiles,
                             int64_t tile_capacity, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (tile_capacity < ntiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tile_counts_kernel<<<(unsigned int)ntiles, kScanThreads, 0, s>>>(
      (const uint32_t*)words, (uint64_t)nbits, (const int32_t*)idx, n,
      (int32_t*)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles_kernel<<<1, kScanTileThreads, 0, s>>>((int32_t*)tiles, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_cumsum_kernel<<<(unsigned int)ntiles, kScanThreads, 0, s>>>(
      (const uint32_t*)words, (uint64_t)nbits, (const int32_t*)idx, n,
      (const int32_t*)tiles, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
