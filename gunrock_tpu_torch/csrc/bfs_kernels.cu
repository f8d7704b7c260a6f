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
// K1 and K10 test one frontier bit for every CSC source, K2 one for
// every id it is given; K14 finds each CSC row's last in-neighbour that
// passes the predecessor fills' test, in K1's warp tiles. The TPU kernels keep the whole mask in VMEM (a
// constant (R, 128) block); here it is held on chip too. K1 and K10 run
// a persistent grid of one block of 32 warps an SM and stream their ids
// with 16-byte loads and the evict-first hint, the next tile's loads
// issued before anything waits on the current one. Where the mask is
// read was measured both ways for each (PERF.md, section 6): K10 reads
// it from shared memory, copied there once a block, and through L1 only
// above the 227 KB a block may hold (the wrapper's size rule,
// ops/kernels.py SHARED_MASK_WORDS); K1 and K2 read it through L1 at
// every size, which was faster for K1, whose warps also hold their row
// starts in shared memory, and for K2 at every launch the BFS path makes.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <climits>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>
#include <cuda_runtime.h>

#include "tiles.cuh"

// K10's dynamic shared memory: the mask, in its shared variant.
extern __shared__ __align__(16) uint32_t smem[];

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBlockThreads = 1024;  // K1, K10: one block an SM
constexpr int kBlockWarps = kBlockThreads / 32;
// K1: a warp tile, kReachQuads 16-byte loads a lane.
constexpr int kReachQuads = 2;
constexpr int kReachItems = 4 * kReachQuads;   // 8 edges a lane
constexpr int kWarpTile = 32 * kReachItems;    // 256 edges a warp tile
// K10: a block tile, kCumsumQuads 16-byte loads a thread.
constexpr int kCumsumQuads = 4;
constexpr int kCumsumQuad = kBlockThreads * 4;                 // 4096 ids
constexpr int kCumsumTile = kCumsumQuad * kCumsumQuads;        // 16384 ids
// K2: 16-byte id loads a thread a trip of its grid-stride loop.
constexpr int kGatherQuads = 4;
// The shared memory a block may opt into on the H100 (227 KB), less
// K10's own: the largest mask K10 holds in shared memory.
constexpr int64_t kSmemCap = 232448;
constexpr int64_t kCumsumStatic = 1024;
constexpr int64_t kCumsumMaskWords = (kSmemCap - kCumsumStatic) / 4;  // 57856

// Bit u of the frontier, from shared memory (kShared, once the block has
// copied the mask there) or through L1.
template <bool kShared>
__device__ __forceinline__ uint32_t frontier_bit(
    const uint32_t* __restrict__ words, uint64_t nbits, int32_t u) {
  const uint32_t i = (uint32_t)u;
  uint32_t w = 0;
  if ((uint64_t)i < nbits) {
    if constexpr (kShared) {
      w = smem[i >> 5];
    } else {
      w = __ldg(words + (i >> 5));
    }
  }
  return (w >> (i & 31u)) & 1u;
}

// The four bits of a quad of ids, as bits 0-3.
template <bool kShared>
__device__ __forceinline__ uint32_t quad_bits(const uint32_t* __restrict__ w,
                                              uint64_t nbits, int4 q) {
  return frontier_bit<kShared>(w, nbits, q.x) |
         frontier_bit<kShared>(w, nbits, q.y) << 1 |
         frontier_bit<kShared>(w, nbits, q.z) << 2 |
         frontier_bit<kShared>(w, nbits, q.w) << 3;
}

// Four ids from e: one 16-byte load where vec and whole, else one at a
// time; past n, -1 (outside any mask).
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p, int64_t n,
                                      int64_t e, bool vec) {
  if (vec && e + 3 < n) return __ldcs(reinterpret_cast<const int4*>(p + e));
  return make_int4(e < n ? __ldcs(p + e) : -1,
                   e + 1 < n ? __ldcs(p + e + 1) : -1,
                   e + 2 < n ? __ldcs(p + e + 2) : -1,
                   e + 3 < n ? __ldcs(p + e + 3) : -1);
}

__device__ __forceinline__ void store4(int32_t* __restrict__ p, int64_t n,
                                       int64_t e, bool vec, int4 v) {
  if (vec && e + 3 < n) {
    *reinterpret_cast<int4*>(p + e) = v;
    return;
  }
  if (e < n) p[e] = v.x;
  if (e + 1 < n) p[e + 1] = v.y;
  if (e + 2 < n) p[e + 2] = v.z;
  if (e + 3 < n) p[e + 3] = v.w;
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
// bit u set in `words`. The entry point zeroes `out` first.
//
// Work is split by edges (an R-MAT hub's row of 10^5 edges spreads over
// hundreds of tiles): warp tiles of kWarpTile consecutive CSC edges, lane
// l holding edges 8 l .. 8 l + 7 of one, each warp striding over the
// tiles on its own with the next tile's edges and rows loaded ahead. The
// rows come from csc_offsets alone, as in K3's pass
// (csrc/pull_kernels.cu): csc_tile_rows_kernel (tiles.cuh) gives the row
// of each tile's first edge. A tile that lies in one row (the middle of a
// hub's) ORs that row's bit in if any of its edges hits. Otherwise the
// warp marks in its own 1 KB of shared memory the position of each row
// that starts inside the tile, reading csc_offsets over the rows
// tile_rows[t] + 1 .. tile_rows[t + 1]; a lane's first row is the largest
// start before its edges (a warp max-scan). csc_edge_dst is not read.
//
// A lane folds its edges in order into runs of one output word (a lane
// where no row starts is one run). A word strictly inside the lane's
// runs has all its edges in the lane: one plain store. Its first and
// last runs (head and tail) join the other lanes' by a segmented OR over
// the lanes' tails; the lane after the last tail of a word, if its head
// is that word, adds its head and stores. Words other than the tile's
// first and last have all their edges in the tile and get one plain
// store; those two get atomicOr, as other tiles may hold edges of them.
// OR is order-free, so no ordering is needed. Zero words are not written.
//
// Bound on the H100: csc_indices streamed once (4 bytes an edge, 243 MB
// at rmat n20 e32), csc_offsets (4 MB) and the two masks: 0.074 ms at
// 3.35 TB/s. What holds it is each tile's chain of steps (its loads, the
// walk over csc_offsets, the scans): warp tiles of 256 edges were faster
// than 512, and a tile in one row skips the chain.
struct ReachArgs {
  const uint32_t* words;
  uint64_t nbits;
  const int32_t* indices;   // csc_indices
  const int32_t* offsets;   // csc_offsets, (rows + 1,)
  int64_t rows;
  int64_t num_edges;
  int64_t ntiles;
  const int32_t* tile_rows; // (ntiles + 1,)
  uint32_t* out;            // (ceil(rows / 32),), zeroed
};

// A word's bits: plain store inside the tile, atomicOr on its first and
// last word.
__device__ __forceinline__ void put_word(uint32_t* __restrict__ out,
                                         int32_t w, uint32_t bits,
                                         int32_t first_w, int32_t last_w) {
  if (bits == 0) return;
  if (w == first_w || w == last_w) {
    atomicOr(out + w, bits);
  } else {
    out[w] = bits;
  }
}

// A K1 tile in which rows start: this lane's edges k < n hit the
// frontier where bit k of hits is set; starts is the warp's kWarpTile
// slots of shared memory.
__device__ __forceinline__ void reach_tile(const ReachArgs& a,
                                           int32_t* starts, int lane,
                                           int64_t lo, int len, int n,
                                           int32_t row0, int32_t row1,
                                           uint32_t hits) {
  int4* const mine = reinterpret_cast<int4*>(starts + kReachItems * lane);
  // Mark the rows that start inside the tile: row0 holds edge lo, so
  // every later row starts after lo; row1 holds the next tile's first
  // edge (or is rows after the last tile).
#pragma unroll
  for (int q = 0; q < kReachQuads; ++q) mine[q] = make_int4(-1, -1, -1, -1);
  __syncwarp();
  for (int64_t r = (int64_t)row0 + 1 + lane; r <= row1 && r < a.rows;
       r += 32) {
    const int32_t s = __ldg(a.offsets + r);
    if (s < lo + len && __ldg(a.offsets + r + 1) > s) {
      starts[s - lo] = (int32_t)r;
    }
  }
  __syncwarp();
  // The row of this lane's first edge: the last start before it.
  int32_t own = -1;
#pragma unroll
  for (int q = 0; q < kReachQuads; ++q) {
    const int4 s4 = mine[q];
    own = max(own, max(max(s4.x, s4.y), max(s4.z, s4.w)));
  }
  int32_t last = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, last, d);
    if (lane >= d) last = max(last, o);
  }
  int32_t row = __shfl_up_sync(kFull, last, 1);
  row = lane > 0 ? max(row, row0) : row0;
  // Fold the lane's edges into runs of one output word. A lane where no
  // row starts holds one run: its bits at once.
  int32_t wcur = row >> 5, wf = -1;
  uint32_t bcur = hits != 0 ? 1u << (row & 31) : 0u, bf = 0;
  bool head = false;
  if (own >= 0) {
    wcur = -1;
    bcur = 0;
#pragma unroll
    for (int q = 0; q < kReachQuads; ++q) {
      const int4 s4 = mine[q];
      const int32_t st[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * q + i;
        if (k < n) {
          if (st[i] >= 0) row = st[i];
          const int32_t w = row >> 5;
          if (w != wcur) {
            if (wcur >= 0) {
              if (!head) {
                wf = wcur;
                bf = bcur;
                head = true;
              } else if (bcur != 0) {
                a.out[wcur] = bcur;
              }
            }
            wcur = w;
            bcur = 0;
          }
          bcur |= ((hits >> k) & 1u) << (row & 31);
        }
      }
    }
  }
  // The lane's head (wf, bf) and tail (wl, bl); a lane of one run has
  // it all in its tail, an empty lane a key past every word.
  int32_t wl = wcur;
  const uint32_t bl = bcur;
  if (!head) {
    wf = wl;
    bf = 0;
  }
  if (n == 0) wf = wl = INT_MAX;
  // Segmented OR of the tails over the lanes (keys nondecreasing).
  uint32_t tail = bl;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, tail, d);
    const int32_t ok = __shfl_up_sync(kFull, wl, d);
    if (lane >= d && ok == wl) tail |= o;
  }
  const int32_t prev_wl = __shfl_up_sync(kFull, wl, 1);
  const uint32_t prev_tail = __shfl_up_sync(kFull, tail, 1);
  const int32_t next_wf = __shfl_down_sync(kFull, wf, 1);
  const int32_t first_w = __shfl_sync(kFull, wf, 0);
  const int32_t last_w = __shfl_sync(kFull, wl, (len - 1) / kReachItems);
  if (wf != wl) {
    put_word(a.out, wf, bf | (lane > 0 && prev_wl == wf ? prev_tail : 0u),
             first_w, last_w);
  }
  if (n > 0 && (lane == 31 || next_wf != wl)) {
    put_word(a.out, wl, tail, first_w, last_w);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
pull_reached_words_kernel(ReachArgs a) {
  __shared__ __align__(16) int32_t block_starts[kBlockWarps * kWarpTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* const starts = block_starts + warp * kWarpTile;
  const bool vec = (reinterpret_cast<uintptr_t>(a.indices) & 15) == 0;
  const int64_t nwarps = (int64_t)gridDim.x * kBlockWarps;
  int64_t t = (int64_t)blockIdx.x * kBlockWarps + warp;
  int4 cur[kReachQuads];
  int32_t row0 = 0, row1 = 0;
  if (t < a.ntiles) {
#pragma unroll
    for (int q = 0; q < kReachQuads; ++q) {
      cur[q] = load4(a.indices, a.num_edges,
                     t * kWarpTile + kReachItems * lane + 4 * q, vec);
    }
    row0 = __ldg(a.tile_rows + t);
    row1 = __ldg(a.tile_rows + t + 1);
  }
  for (; t < a.ntiles; t += nwarps) {
    const int64_t lo = t * kWarpTile;
    const int len = (int)(a.num_edges - lo < kWarpTile ? a.num_edges - lo
                                                        : kWarpTile);
    const int rest = len - kReachItems * lane;
    const int n = rest < 0 ? 0 : (rest < kReachItems ? rest : kReachItems);
    // The next tile's edges and rows go out first.
    const int64_t tn = t + nwarps;
    int4 nxt[kReachQuads];
    int32_t nrow0 = 0, nrow1 = 0;
    if (tn < a.ntiles) {
#pragma unroll
      for (int q = 0; q < kReachQuads; ++q) {
        nxt[q] = load4(a.indices, a.num_edges,
                       tn * kWarpTile + kReachItems * lane + 4 * q, vec);
      }
      nrow0 = __ldg(a.tile_rows + tn);
      nrow1 = __ldg(a.tile_rows + tn + 1);
    }
    // This lane's frontier bits (edges past the end read -1: 0).
    uint32_t hits = 0;
#pragma unroll
    for (int q = 0; q < kReachQuads; ++q) {
      hits |= quad_bits<false>(a.words, a.nbits, cur[q]) << (4 * q);
    }
    if (row0 == row1) {
      // The whole tile lies in row0 (the middle of a hub's row): one bit.
      if (__any_sync(kFull, hits != 0) && lane == 0) {
        atomicOr(a.out + (row0 >> 5), 1u << (row0 & 31));
      }
    } else {
      reach_tile(a, starts, lane, lo, len, n, row0, row1, hits);
    }
#pragma unroll
    for (int q = 0; q < kReachQuads; ++q) cur[q] = nxt[q];
    row0 = nrow0;
    row1 = nrow1;
  }
}

// K2: out[i] = bit idx[i] of a packed mask, as 0/1 int32; ids outside
// the mask read 0 (frontier_bit).
//
// Replaces gunrock_tpu/ops/pallas_kernels.py _gather_kernel (:71) behind
// bitmask_gather (:116), which loops over the VMEM-resident table rows
// because a TPU core cannot gather across them. Here the mask stays on
// chip as the TPU keeps it in VMEM, read through L1 (__ldg) by a grid of
// 256-thread blocks. A copy into shared memory costs the whole mask a
// block (128 KB at the flagship's 32,768 words), which was measured to
// pay only from about 9 ids a mask word, and the BFS path's launches
// stay far below that (PERF.md, section 6).
//
// Ids are read and bits written 16 bytes a thread (kGatherQuads loads in
// flight a trip, each warp's on one contiguous 512-byte run), with the
// streaming hints. The single-source push passes a view of col_indices
// that starts at any 4-byte offset: the wrapper gives out the same
// offset mod 16 as idx, so one scalar head (up to the first 16-byte
// boundary) and one scalar tail serve both; where the two offsets differ
// every id takes the scalar path. The scalar ids go to the grid's last
// threads, which the launch leaves without quads unless the grid is
// capped, so that no thread of a short launch waits on two chains of
// loads, a quad's and then a scalar's.
//
// Bound on the H100: the 4-byte id read and the 4-byte bit written, 8
// bytes an id, and the mask once (0.0101 ms at 2^22 ids and 2^20 bits).
struct GatherArgs {
  const uint32_t* words;
  uint64_t nbits;
  const int32_t* idx;
  int64_t n;
  int64_t head;    // scalar ids before the quads (all n where not aligned)
  int64_t nquads;  // 16-byte quads from idx + head
  int32_t* out;
};

// A trip's kGatherQuads quads from q0 on, stride apart (past nquads:
// left as they are).
__device__ __forceinline__ void load_quads(const int4* __restrict__ in4,
                                           int64_t nquads, int64_t q0,
                                           int64_t stride,
                                           int4 (&v)[kGatherQuads]) {
#pragma unroll
  for (int u = 0; u < kGatherQuads; ++u) {
    if (q0 + u * stride < nquads) v[u] = __ldcs(in4 + q0 + u * stride);
  }
}

__global__ void __launch_bounds__(kThreads)
bitmask_gather_kernel(GatherArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* const in4 = reinterpret_cast<const int4*>(a.idx + a.head);
  int4* const out4 = reinterpret_cast<int4*>(a.out + a.head);
  int4 v[kGatherQuads] = {};
  load_quads(in4, a.nquads, gtid, stride, v);
  for (int64_t q0 = gtid; q0 < a.nquads; q0 += kGatherQuads * stride) {
    int4 nxt[kGatherQuads] = {};
    load_quads(in4, a.nquads, q0 + kGatherQuads * stride, stride, nxt);
#pragma unroll
    for (int u = 0; u < kGatherQuads; ++u) {
      const int64_t q = q0 + u * stride;
      if (q < a.nquads) {
        const uint32_t b = quad_bits<false>(a.words, a.nbits, v[u]);
        __stcs(out4 + q, make_int4((int)(b & 1u), (int)((b >> 1) & 1u),
                                   (int)((b >> 2) & 1u), (int)(b >> 3)));
      }
      v[u] = nxt[u];
    }
  }
  // The scalar head and tail (at most 3 ids each, or every id where idx
  // and out are not aligned alike), counted down from the grid's last
  // thread.
  const int64_t tail = a.head + 4 * a.nquads;
  const int64_t nscalar = a.n - 4 * a.nquads;
  for (int64_t j = stride - 1 - gtid; j < nscalar; j += stride) {
    const int64_t i = j < a.head ? j : tail + (j - a.head);
    a.out[i] = (int32_t)frontier_bit<false>(a.words, a.nbits,
                                            __ldcs(a.idx + i));
  }
}

// K10: out[i] = bit idx[0] + ... + bit idx[i] of a packed mask, an
// inclusive int32 running sum.
//
// Replaces gunrock_tpu/ops/pallas_kernels.py _gather_cumsum_kernel (:829)
// behind bitmask_gather_cumsum (:880). That kernel carries the running
// total from one grid step to the next in SMEM, which only works because a
// TPU runs its grid in order on one core. Here one launch reads each id
// once and passes the totals between tiles by a decoupled look-back
// (tiles.cuh), as K7 does (csrc/sssp_kernels.cu).
//
// A tile is kCumsumTile (16384) ids a block: thread t's quad q holds ids
// lo + 4096 q + 4 t .. + 3, so each of a warp's four 16-byte loads, and
// each store, is one contiguous 512-byte run. The block takes its tiles
// from the counter in state[0], one tile ahead: thread 0 asks for the
// next tile as the current one starts. Four ballots a quad give each
// lane the hits of the lanes before it and its warp's total; warp 0
// scans the 128 warp-quad totals in id order and publishes the tile's
// count; the block issues the next tile's loads; then warp 0 looks back
// to the nearest inclusive prefix while those loads are in flight,
// publishes its own, and the block stores its sums 16 bytes at a time.
// Warp tiles of 512 ids with a look-back each were built first and
// measured slower (PERF.md, section 6): with 4224 tiles in flight a
// look-back walks far, 32 tiles a step, before it meets an inclusive
// prefix; 132 block tiles in flight keep the walks short. Tiles carry
// their counts in 32 bits and the sums are stored as int32 modulo 2^32
// (the JAX kernel's int32 output): past 2^31 hits, on a sizet64 graph's
// pull, they wrap, and a difference of two sums stays exact while fewer
// than 2^32 hits lie between them.
//
// Bound on the H100: the 4-byte id read and the 4-byte sum written, 8
// bytes an id (0.145 ms over the 60.7M CSC sources at rmat n20 e32).
struct CumsumArgs {
  const uint32_t* words;
  uint64_t nbits;
  const int32_t* idx;
  int64_t n;
  int64_t ntiles;
  uint64_t* state;   // (1 + ntiles,) zeroed: the counter, a count a tile
  int32_t* out;
};

template <bool kShared>
__global__ void __launch_bounds__(kBlockThreads, 1)
gather_cumsum_kernel(CumsumArgs a) {
  // The warp-quad totals, then their exclusive prefixes, entry
  // kBlockWarps * q + warp; the next tile; the tile's exclusive prefix.
  __shared__ int s_count[kCumsumQuads * kBlockWarps];
  __shared__ int64_t s_next, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (kShared) {
    // The mask, once a block (the barrier below ends the copy).
    const int64_t nwords = (int64_t)(a.nbits >> 5);
    for (int64_t i = tid; i < nwords; i += kBlockThreads) {
      smem[i] = __ldg(a.words + i);
    }
  }
  const uint32_t below = (1u << lane) - 1u;
  const bool vec = ((reinterpret_cast<uintptr_t>(a.idx) |
                     reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
  unsigned long long* const counter =
      reinterpret_cast<unsigned long long*>(a.state);
  if (tid == 0) s_next = (int64_t)atomicAdd(counter, 1ull);
  __syncthreads();
  int64_t c = s_next;
  int4 cur[kCumsumQuads];
  if (c < a.ntiles) {
#pragma unroll
    for (int q = 0; q < kCumsumQuads; ++q) {
      cur[q] = load4(a.idx, a.n, c * kCumsumTile + kCumsumQuad * q + 4 * tid,
                     vec);
    }
  }
  while (c < a.ntiles) {
    if (tid == 0) s_next = (int64_t)atomicAdd(counter, 1ull);
    uint32_t hits = 0;
#pragma unroll
    for (int q = 0; q < kCumsumQuads; ++q) {
      hits |= quad_bits<kShared>(a.words, a.nbits, cur[q]) << (4 * q);
    }
    int before[kCumsumQuads];
#pragma unroll
    for (int q = 0; q < kCumsumQuads; ++q) {
      int b = 0, total = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned ball = __ballot_sync(kFull, (hits >> (4 * q + i)) & 1u);
        b += __popc(ball & below);
        total += __popc(ball);
      }
      before[q] = b;
      if (lane == 0) s_count[kBlockWarps * q + warp] = total;
    }
    __syncthreads();
    uint64_t* const mine = a.state + 1 + c;
    int tile_total = 0;
    if (warp == 0) {
      // Lane l scans entries kCumsumQuads l .. kCumsumQuads (l + 1) - 1,
      // which follow each other in id order.
      int v[kCumsumQuads];
      int sum = 0;
#pragma unroll
      for (int k = 0; k < kCumsumQuads; ++k) {
        v[k] = s_count[kCumsumQuads * lane + k];
        sum += v[k];
      }
      int x = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      int run = x - sum;
#pragma unroll
      for (int k = 0; k < kCumsumQuads; ++k) {
        s_count[kCumsumQuads * lane + k] = run;
        run += v[k];
      }
      tile_total = __shfl_sync(kFull, x, 31);
      if (lane == 0) {
        store_word(mine, (c == 0 ? kInclusive : kReady) |
                             (uint32_t)tile_total);
      }
    }
    __syncthreads();
    // The next tile's ids go out before this one waits on its
    // predecessors.
    const int64_t next = s_next;
    int4 nxt[kCumsumQuads];
    if (next < a.ntiles) {
#pragma unroll
      for (int q = 0; q < kCumsumQuads; ++q) {
        nxt[q] = load4(a.idx, a.n,
                       next * kCumsumTile + kCumsumQuad * q + 4 * tid, vec);
      }
    }
    if (warp == 0) {
      int64_t excl = 0;
      if (c > 0) {
        excl = warp_lookback(a.state + 1, 1, c, lane);
        if (lane == 0) {
          store_word(mine, kInclusive | (uint32_t)(excl + tile_total));
        }
      }
      if (lane == 0) s_excl = excl;
    }
    __syncthreads();
    // Sums modulo 2^32 in uint32_t (signed overflow is undefined), their
    // bits stored as int32: past 2^31 hits they wrap, as the plain
    // version's do.
    const uint32_t base = (uint32_t)s_excl;
#pragma unroll
    for (int q = 0; q < kCumsumQuads; ++q) {
      const uint32_t h = hits >> (4 * q);
      const uint32_t x = base + (uint32_t)s_count[kBlockWarps * q + warp] +
                         (uint32_t)before[q] + (h & 1u);
      const uint32_t y = x + ((h >> 1) & 1u);
      const uint32_t z = y + ((h >> 2) & 1u);
      const uint32_t w = z + ((h >> 3) & 1u);
      const uint4 u = make_uint4(x, y, z, w);
      int4 o;
      memcpy(&o, &u, sizeof(o));
      store4(a.out, a.n, c * kCumsumTile + kCumsumQuad * q + 4 * tid, vec, o);
    }
#pragma unroll
    for (int q = 0; q < kCumsumQuads; ++q) cur[q] = nxt[q];
    c = next;
  }
}

// K14: the last hit of every CSC row, for the predecessor fills of BFS
// and SSSP (models/bfs.py and models/sssp.py _fill_preds): out[v] = the
// largest CSC position p in row v whose in-neighbour u = indices[p]
// passes the fill's test, or -1. The test (parent_hit): u's label is
// v's less one (BFS, int32 labels); or u is strictly nearer than v and
// its distance plus the edge's weight, one float32 add rounded to
// nearest, is v's (SSSP). Positions are 64-bit whatever the offsets'
// type, so the fill stays exact past 2^31 edges.
//
// Replaces no TPU kernel: the JAX package's fills are XLA's cummax over
// the hit positions of every CSC edge (gunrock_tpu/models/bfs.py:373-386,
// models/sssp.py:623-638). The port's plain version
// (ops/kernels.py last_hit_rows_plain) takes a float64 segment_reduce over
// every row for each chunk of 2^24 edges: about 43 ms at Graph500 scale
// 22 on the H100 (PERF.md, section 5).
//
// Bound on the H100: csc_indices streamed once (4 bytes an edge, 513 MB
// at Graph500 scale 22), the offsets and the values (2 x 16.8 MB) and an
// 8-byte word written a row: about 0.58 GB, 0.17 ms at 3.35 TB/s; SSSP
// adds csc_edge_values (another 513 MB): 0.34 ms. The gathers of vals[u]
// land in the 50 MB L2.
//
// Kronecker rows hold 0 to about 10^5 in-edges, so work is split by
// edges, not rows: each warp takes a contiguous run of warp tiles of
// kHitTile edges (lane l holds edges 8 l .. 8 l + 7 of a tile, loaded 16
// bytes at a time, the next tile's loads issued first) and finds the row
// of its first edge once, by a binary search of the offsets. A tile
// marks in the warp's 1 KB of shared memory the position of each
// nonempty row that starts inside it, reading the offsets 32 rows a step
// from the row it carries over (that of the edge before it); a lane's
// first row is the largest start before its edges (a warp max-scan), as
// in K1. No tile-rows prologue runs, and csc_edge_dst is not read. A hit
// is its row's last in the tile when the tile's next hit lies in another
// row (the next lane with a hit found by a ballot). Rows strictly
// between the tile's first and last rows lie wholly inside it and get
// one plain store; those two get atomicMax, as other tiles may hold hits
// of them. A max does not depend on the order of the updates, so two
// launches agree bit for bit. The entry point sets the output to -1 (all
// bytes 0xff) before the launch.
constexpr int kHitQuads = 2;
constexpr int kHitItems = 4 * kHitQuads;    // 8 edges a lane
constexpr int kHitTile = 32 * kHitItems;    // 256 edges a warp tile
static_assert(kHitQuads == 2, "last_hit_rows_kernel unpacks two quads");

template <typename Off>
struct HitArgs {
  const Off* offsets;       // csc_offsets, (rows + 1,)
  const int32_t* indices;   // csc_indices
  const void* vals;         // (rows,) int32 labels or float32 distances
  const float* weights;     // csc_edge_values (SSSP's test only)
  int64_t rows;
  int64_t num_edges;
  int64_t ntiles;
  int64_t tiles_per_warp;
  long long* out;           // (rows,), -1 before the launch
};

// int32 arithmetic wraps, as the plain version's does.
__device__ __forceinline__ bool parent_hit(int32_t du, int32_t dv, float) {
  return (uint32_t)du + 1u == (uint32_t)dv;
}

__device__ __forceinline__ bool parent_hit(float du, float dv, float w) {
  return du < dv && __fadd_rn(du, w) == dv;
}

// A row's last hit in a tile: a plain store for a row wholly inside the
// tile, atomicMax for the tile's first and last rows.
__device__ __forceinline__ void put_hit(long long* __restrict__ out,
                                        int32_t r, int64_t pos,
                                        int32_t first, int32_t last) {
  if (r != first && r != last) {
    out[r] = pos;
  } else {
    atomicMax(out + r, (long long)pos);
  }
}

template <bool kWeighted, typename Off>
__global__ void __launch_bounds__(kBlockThreads, 1)
last_hit_rows_kernel(HitArgs<Off> a) {
  using T = typename std::conditional<kWeighted, float, int32_t>::type;
  __shared__ __align__(16) int32_t block_starts[kBlockWarps * kHitTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* const starts = block_starts + warp * kHitTile;
  int4* const mine = reinterpret_cast<int4*>(starts + kHitItems * lane);
  const T* const vals = static_cast<const T*>(a.vals);
  const int32_t* const wbits = reinterpret_cast<const int32_t*>(a.weights);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.indices) |
                     reinterpret_cast<uintptr_t>(a.weights)) & 15) == 0;
  int64_t t = ((int64_t)blockIdx.x * kBlockWarps + warp) * a.tiles_per_warp;
  const int64_t t_end = min(t + a.tiles_per_warp, a.ntiles);
  if (t >= t_end) return;
  // The row of the warp's first edge: the last row that starts at or
  // before it (a nonempty one).
  int64_t lo_r = 0, hi_r = a.rows;
  while (hi_r - lo_r > 1) {
    const int64_t mid = (lo_r + hi_r) >> 1;
    if ((int64_t)__ldg(a.offsets + mid) <= t * kHitTile) {
      lo_r = mid;
    } else {
      hi_r = mid;
    }
  }
  // The row carried into a tile: that of the edge before it (of its
  // first edge, in the warp's first tile). Every later nonempty row
  // starts inside the tile or past it.
  int32_t row = (int32_t)lo_r;
  int4 cur[kHitQuads], wcur[kHitQuads] = {};
#pragma unroll
  for (int q = 0; q < kHitQuads; ++q) {
    const int64_t e = t * kHitTile + kHitItems * lane + 4 * q;
    cur[q] = load4(a.indices, a.num_edges, e, vec);
    if constexpr (kWeighted) wcur[q] = load4(wbits, a.num_edges, e, vec);
  }
  for (; t < t_end; ++t) {
    const int64_t lo = t * kHitTile;
    const int64_t hi = min(lo + kHitTile, a.num_edges);
    const int rest = (int)(hi - lo) - kHitItems * lane;
    const int n = rest < 0 ? 0 : (rest < kHitItems ? rest : kHitItems);
    // The next tile's edges go out first.
    int4 nxt[kHitQuads] = {}, wnxt[kHitQuads] = {};
    if (t + 1 < t_end) {
#pragma unroll
      for (int q = 0; q < kHitQuads; ++q) {
        const int64_t e = lo + kHitTile + kHitItems * lane + 4 * q;
        nxt[q] = load4(a.indices, a.num_edges, e, vec);
        if constexpr (kWeighted) wnxt[q] = load4(wbits, a.num_edges, e, vec);
      }
    }
    // The in-neighbours' values (edges past the end read -1: none).
    const int32_t u[kHitItems] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w,
                                  cur[1].x, cur[1].y, cur[1].z, cur[1].w};
    const int32_t wb[kHitItems] = {wcur[0].x, wcur[0].y, wcur[0].z,
                                   wcur[0].w, wcur[1].x, wcur[1].y,
                                   wcur[1].z, wcur[1].w};
    T du[kHitItems];
#pragma unroll
    for (int k = 0; k < kHitItems; ++k) {
      du[k] = u[k] >= 0 ? __ldg(vals + u[k]) : T(0);
    }
    // Mark the nonempty rows that start inside the tile, 32 rows a step
    // from the one after the carried row, up to the first at or past hi.
#pragma unroll
    for (int q = 0; q < kHitQuads; ++q) mine[q] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    for (int64_t base = (int64_t)row + 1;; base += 32) {
      const int64_t r = base + lane;
      bool past = r >= a.rows;
      if (!past) {
        const int64_t s = __ldg(a.offsets + r);
        past = s >= hi;
        if (!past && (int64_t)__ldg(a.offsets + r + 1) > s) {
          starts[s - lo] = (int32_t)r;
        }
      }
      if (__any_sync(kFull, past)) break;
    }
    __syncwarp();
    int32_t st[kHitItems];
    int32_t own = -1;
#pragma unroll
    for (int q = 0; q < kHitQuads; ++q) {
      const int4 s4 = mine[q];
      st[4 * q] = s4.x;
      st[4 * q + 1] = s4.y;
      st[4 * q + 2] = s4.z;
      st[4 * q + 3] = s4.w;
      own = max(own, max(max(s4.x, s4.y), max(s4.z, s4.w)));
    }
    int32_t incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    const int32_t before = __shfl_up_sync(kFull, incl, 1);
    // The rows of the tile's first and last edges.
    const int32_t first = max(row, __shfl_sync(kFull, st[0], 0));
    const int32_t last = max(row, __shfl_sync(kFull, incl, 31));
    // The lane's edges in order: a hit followed by one in another row is
    // its row's last in the tile.
    int32_t r = lane > 0 ? max(row, before) : row;
    T dv = __ldg(vals + r);
    int32_t prow = -1, frow = -1;
    int64_t ppos = -1;
#pragma unroll
    for (int k = 0; k < kHitItems; ++k) {
      if (st[k] >= 0) {
        r = st[k];
        dv = __ldg(vals + r);
      }
      if (k < n && parent_hit(du[k], dv, __int_as_float(wb[k]))) {
        if (prow >= 0 && prow != r) put_hit(a.out, prow, ppos, first, last);
        if (frow < 0) frow = r;
        prow = r;
        ppos = lo + kHitItems * lane + k;
      }
    }
    // The lane's last hit is its row's last unless the next lane with a
    // hit has its first in the same row.
    const unsigned with_hits = __ballot_sync(kFull, prow >= 0);
    const unsigned later = lane == 31 ? 0u : with_hits & (~0u << (lane + 1));
    const int32_t next_row =
        __shfl_sync(kFull, frow, later ? __ffs(later) - 1 : lane);
    if (prow >= 0 && (later == 0 || next_row != prow)) {
      put_hit(a.out, prow, ppos, first, last);
    }
    row = last;
#pragma unroll
    for (int q = 0; q < kHitQuads; ++q) {
      cur[q] = nxt[q];
      wcur[q] = wnxt[q];
    }
  }
}

unsigned int blocks_for(int64_t threads) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Once a device: K10's shared variant may take the mask's shared memory
// and prefers the whole carveout; K1, K2, K10's L1 variant and K14
// prefer the least, so that L1 keeps the mask (K14: the values it
// gathers).
void configure_tiles() {
  static bool done[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64 ||
      done[dev]) {
    return;
  }
  cudaFuncSetAttribute((const void*)gather_cumsum_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(4 * kCumsumMaskWords));
  cudaFuncSetAttribute((const void*)gather_cumsum_kernel<true>,
                       cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  for (const void* k : {(const void*)gather_cumsum_kernel<false>,
                        (const void*)bitmask_gather_kernel,
                        (const void*)pull_reached_words_kernel,
                        (const void*)last_hit_rows_kernel<false, int32_t>,
                        (const void*)last_hit_rows_kernel<false, int64_t>,
                        (const void*)last_hit_rows_kernel<true, int32_t>,
                        (const void*)last_hit_rows_kernel<true, int64_t>}) {
    cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                         0);
  }
  done[dev] = true;
}

// One block an SM, or one a unit of work where there are fewer.
unsigned int persistent_grid(int64_t blocks) {
  const int64_t sms = sm_count();
  return (unsigned int)(blocks < sms ? blocks : sms);
}

template <bool kWeighted, typename Off>
void launch_last_hit(const void* offsets, const void* indices,
                     const void* vals, const void* weights, int64_t rows,
                     int64_t num_edges, void* out, cudaStream_t s) {
  HitArgs<Off> a;
  a.offsets = (const Off*)offsets;
  a.indices = (const int32_t*)indices;
  a.vals = vals;
  a.weights = (const float*)weights;
  a.rows = rows;
  a.num_edges = num_edges;
  a.ntiles = (num_edges + kHitTile - 1) / kHitTile;
  const unsigned int grid =
      persistent_grid((a.ntiles + kBlockWarps - 1) / kBlockWarps);
  const int64_t warps = (int64_t)grid * kBlockWarps;
  a.tiles_per_warp = (a.ntiles + warps - 1) / warps;
  a.out = (long long*)out;
  last_hit_rows_kernel<kWeighted, Off><<<grid, kBlockThreads, 0, s>>>(a);
}

}  // namespace

extern "C" {

// K1. tile_rows: scratch of tile_capacity int32, at least
// ceil(num_edges / 256) + 1.
int gr_pull_reached_words(const void* words, int64_t nbits,
                          const void* indices, const void* offsets,
                          int64_t rows, int64_t num_edges, void* tile_rows,
                          int64_t tile_capacity, void* out, void* stream) {
  const int64_t ntiles = (num_edges + kWarpTile - 1) / kWarpTile;
  if (rows < 0 || num_edges < 0 || nbits < 0 ||
      (num_edges > 0 && rows == 0) || tile_capacity < ntiles + 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, (size_t)((rows + 31) / 32) * sizeof(uint32_t), s);
  if (num_edges == 0) return (int)cudaGetLastError();
  configure_tiles();
  csc_tile_rows_kernel<kWarpTile><<<blocks_for(rows), kThreads, 0, s>>>(
      (const int32_t*)offsets, rows, num_edges, (int32_t*)tile_rows);
  ReachArgs a;
  a.words = (const uint32_t*)words;
  a.nbits = (uint64_t)nbits;
  a.indices = (const int32_t*)indices;
  a.offsets = (const int32_t*)offsets;
  a.rows = rows;
  a.num_edges = num_edges;
  a.ntiles = ntiles;
  a.tile_rows = (const int32_t*)tile_rows;
  a.out = (uint32_t*)out;
  pull_reached_words_kernel<<<persistent_grid((ntiles + kBlockWarps - 1) /
                                              kBlockWarps),
                              kBlockThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int gr_bitmask_gather(const void* words, int64_t nbits, const void* idx,
                      int64_t n, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nbits < 0 || nbits % 32 != 0) return (int)cudaErrorInvalidValue;
  GatherArgs a;
  a.words = (const uint32_t*)words;
  a.nbits = (uint64_t)nbits;
  a.idx = (const int32_t*)idx;
  a.n = n;
  a.out = (int32_t*)out;
  const uintptr_t pi = reinterpret_cast<uintptr_t>(idx);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  a.head = n;
  a.nquads = 0;
  if (((pi ^ po) & 15) == 0 && (pi & 3) == 0) {
    const int64_t head = (int64_t)((16 - (pi & 15)) & 15) / 4;
    a.head = head < n ? head : n;
    a.nquads = (n - a.head) / 4;
  }
  const int64_t work = a.nquads + (n - 4 * a.nquads);  // quads and scalars
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 8 * sm_count();
  configure_tiles();
  bitmask_gather_kernel<<<(unsigned int)(blocks < cap ? blocks : cap),
                          kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K10. state: scratch of state_words 64-bit words, at least
// 1 + ceil(n / 16384), zeroed here. shared: read the mask from shared
// memory (at most kCumsumMaskWords words), else through L1.
int gr_bitmask_gather_cumsum(const void* words, int64_t nbits,
                             const void* idx, int64_t n, void* state,
                             int64_t state_words, int shared, void* out,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t ntiles = (n + kCumsumTile - 1) / kCumsumTile;
  if (nbits < 0 || nbits % 32 != 0 || state_words < 1 + ntiles ||
      (shared && nbits / 32 > kCumsumMaskWords)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(state, 0, (size_t)(1 + ntiles) * sizeof(uint64_t), s);
  configure_tiles();
  CumsumArgs a;
  a.words = (const uint32_t*)words;
  a.nbits = (uint64_t)nbits;
  a.idx = (const int32_t*)idx;
  a.n = n;
  a.ntiles = ntiles;
  a.state = (uint64_t*)state;
  a.out = (int32_t*)out;
  if (shared) {
    gather_cumsum_kernel<true><<<persistent_grid(ntiles), kBlockThreads,
                                 (size_t)(nbits / 32) * 4, s>>>(a);
  } else {
    gather_cumsum_kernel<false><<<persistent_grid(ntiles), kBlockThreads, 0,
                                  s>>>(a);
  }
  return (int)cudaGetLastError();
}

// K14. offsets64: csc_offsets are int64, else int32. weights: null for
// BFS's test on int32 labels, csc_edge_values for SSSP's on float32
// distances. out: (rows,) int64, set to -1 here, then the last hits.
int gr_last_hit_rows(const void* offsets, int offsets64, const void* indices,
                     const void* vals, const void* weights, int64_t rows,
                     int64_t num_edges, void* out, void* stream) {
  if (rows < 0 || rows > INT_MAX || num_edges < 0 ||
      (num_edges > 0 && rows == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0xff, (size_t)rows * sizeof(long long), s);
  if (num_edges == 0) return (int)cudaGetLastError();
  configure_tiles();
  if (weights == nullptr) {
    if (offsets64) {
      launch_last_hit<false, int64_t>(offsets, indices, vals, weights, rows,
                                      num_edges, out, s);
    } else {
      launch_last_hit<false, int32_t>(offsets, indices, vals, weights, rows,
                                      num_edges, out, s);
    }
  } else if (offsets64) {
    launch_last_hit<true, int64_t>(offsets, indices, vals, weights, rows,
                                   num_edges, out, s);
  } else {
    launch_last_hit<true, int32_t>(offsets, indices, vals, weights, rows,
                                   num_edges, out, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
