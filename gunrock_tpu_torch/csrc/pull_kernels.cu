// Hopper (sm_90a) value-pull kernels behind a plain C interface that
// gunrock_tpu_torch/ops/pull2.py loads with ctypes (built with
// bfs_kernels.cu into one library by gunrock_tpu_torch/ops/_build.py).
//
// K3 pull_reduce:  out[v] = init[v] (+) ((+) over CSC row v of f(values[u], w))
// K4 power iters:  iters rounds of rank' = v < n ? reset + d * sum(rank[u] * w) : 0,
//                  with a per-round count of |rank' - rank| > threshold.
// K6 min sweeps:   sweeps rounds of d' = min(d, min over CSC row v of f(d[u], w)),
//                  with a per-sweep count of d'[v] < d[v].
// K9 Brandes:      levels of Betweenness Centrality's forward or backward
//                  phase as level-gated sum pulls, with a per-level count.
//
// Replaces the TPU kernels behind gunrock_tpu/ops/pull2.py pull_reduce2
// (:268, _pull2_kernel :57), pull_power_iters (:842, _power_kernel :605),
// pull_min_sweeps (:554, _sweeps_kernel :323), brandes_fwd_levels /
// brandes_bwd_levels (:1165 / :1186, _brandes_kernel :895) and
// gunrock_tpu/ops/pallas_kernels.py pull_vertex_reduce (:540,
// _blocked_value_kernel :456). Those stream a blocked, source-grouped
// edge layout through VMEM, because a TPU core cannot gather from HBM,
// and carry per-destination partials across the sequential grid in a
// VMEM accumulator. Here the plain CSC is read directly and every
// vertex value is gathered from L2 (a 2^20-vertex table is 4 MB).
//
// Determinism. There are no float atomics: every output and every
// partial has exactly one writer, and every sum is taken in an order
// that depends only on the graph and on the tile size, never on
// scheduling.
//
// Load balance. R-MAT hub rows hold over 10^5 in-edges, so work is cut
// by edges, not by rows: pass 1 gives each block one tile of kTile (2048)
// consecutive CSC edges, kItems (8) to a thread. The rows come from
// csc_offsets alone, as in merge-based SpMV (Merrill and Garland, SC16):
// a V-wide prologue, once per host call, writes tile_rows[t], the row of
// tile t's first edge (each nonempty row writes the tiles whose first
// edge it holds), and a tile marks in shared memory the position of each
// row that starts inside it, reading csc_offsets over the rows
// tile_rows[t] + 1 .. tile_rows[t + 1]. Every edge is then a position in
// a tile, and csc_edge_dst is not read.
//
// Pass 1, a tile: each thread loads its 8 sources with two 16-byte loads
// (scalar loads at a ragged end or a misaligned base; the edge stream is
// read with the evict-first hint, so L2 keeps the value table), issues
// its 8 gathers before using any, and reduces its run of edges in order.
// A block-wide scan joins the threads in a fixed tree: an exclusive
// prefix max of the rows that start in each thread gives every thread the
// row it continues, and an exclusive segmented scan of the threads'
// trailing partials gives the value it continues. Each thread then closes
// the runs that end in it (rowval[row]); the tile's first run also goes
// to head[t] and its last to tail[t]. Pass 2 gives one thread to each
// row: a row whose edges lie in one tile reads rowval (written by that
// tile alone); a row that spans tiles t0..t1 combines tail[t0],
// head[t0+1..t1-1] (whole tiles of the row) and head[t1] in tile order.
// Rows that span tiles also get rowval writes from several tiles;
// nothing reads those.
//
// Per-source weights. With the "wpr" stream, f(values[u], w[u]) depends
// on the source alone, so a V-sized pass folds it into one value a
// vertex first (vscratch) and pass 1 pulls that with f = none: one
// random gather an edge instead of two. Each folded value is the same
// float32 result the per-edge f would give, so the sums do not change.
//
// Bound on the H100: 4 bytes an edge streamed from HBM (csc_indices:
// 243 MB at rmat n20 e32, 0.072 ms at 3.35 TB/s; plus the weights where
// read) and the V-wide vectors, plus one random 32-byte L2 sector per
// gathered value that misses L1: up to 1.9 GB of L2 traffic a pull at
// that size. Measured there (tools/profile_pull.py), pass 1 takes about
// 0.35 ms with the real sources and 0.24 with every source set to one
// vertex, whose gathers all hit L1: the tile's chain of dependent loads
// holds the second, the gathers' L2 sectors add the rest. L1 capacity
// cuts the gathers more than resident blocks cut the chain, so pass 1
// asks for the least shared memory three blocks need (kCarveout); that
// beat more resident blocks, a shorter or longer tile, and a design
// without the shared array that found each thread's row by a binary
// search of csc_offsets.
//
// K4 runs K3's pass 1 a round, so its rounds equal K3 sum/mul/wpr
// followed by the epilogue, bit for bit. Its finish is its own: the
// epilogue, the count of changed rows a block at a time (an atomic a
// warp on one counter queues when most rows move, as at threshold 0),
// and the next round's folded values rank' * 1/out-degree, so only the
// first round has a fold pass. A round of its own, with the rows'
// structure built once a call and a persistent pass 1 fed by bulk
// copies, was measured and dropped: its pass 1 was no faster than K3's
// (PERF.md, section 6).
//
// K6 is K3's min pull with init = d, a sweep at a time, the change count
// fused into pass 2. The TPU kernel is Gauss-Seidel: its blocks run in
// order and update the distances in place, odd sweeps backward. Here a
// sweep reads one buffer and writes the other (Jacobi), so a sweep's
// result and its count depend on the input alone: they equal the plain
// version's, and a sweep that changes nothing is a fixpoint whatever its
// parity. Every sweep is enqueued from one host call with no host read,
// as K4's rounds are.
//
// K9 runs `levels` Brandes levels from one host call, three kernels a
// level on one stream. Forward level d: a V-wide gate writes gated[u] =
// sig[u] where lab[u] == d - 1, else 0; pass 1 sums gated over the CSC;
// the finish adds each undiscovered row's total into sig and labels it d
// where sig > 0. Backward ring t: the gate writes (1 + delta[v]) /
// max(sig[v], 1e-30) where lab[v] == t + 1; the finish sets delta[u] =
// sig[u] * (delta[u] + total) where lab[u] == t. Pulls reduce over
// in-edges, so the backward ring needs a symmetric edge set, as on the
// TPU. lab is float32 depth (+inf unreached): exact below 2^24 levels.
// lab, sig and delta stay in HBM (12 MB at 2^20 vertices, mostly
// L2-resident), where the TPU kernel keeps them in VMEM.
//
// Activity gating (K6 and K9; the TPU kernels skip the vertex groups
// whose sources did not change, gunrock_tpu/ops/pull2.py:312-313, :384-389
// and :886-889). A round marks which groups of 2^gshift consecutive
// source vertices are active, one bit a group in kGroupWords words (1024
// groups, of 1024 vertices at 2^20), and every warp of pass 1 holds them
// in its registers, word i in lane i. After its index load and the
// starts walk, an edge's test is a shuffle and a shift; an edge whose
// group is inactive gathers nothing and contributes the identity. Why
// groups and not a bit a vertex: measured on the H100 (PERF.md), a bit a
// vertex in L1 (128 KB at 2^20) costs each edge a random L1 access, as
// much as the gather it saves: a dense K6 sweep took 0.51 ms against the
// ungated pass's 0.35, and with the bits read from L2 three times that.
// The shuffle costs a dense sweep about 1.5%. Reading a whole group when
// one of its vertices is active keeps every rule below exact: the extra
// edges add only terms the ungated pass takes too. The writers (K6's seed
// pass and finish, K9's gate) set a group's bit with one atomicOr a warp
// whose rows hold an active vertex; round r reads one half of a two-round
// buffer while block 0 of its pass 1 clears the other half for round
// r + 1.
//
// A block-wide vote at the barrier before the scan finds the tiles with
// no active edge ("quiet"): such a tile has issued no gather and skips
// the scan and the emits, writes the identity to its head and tail
// partials and marks itself quiet in tmark, and pass 2 reads the identity
// for a row that lies in one quiet tile (its rowval is stale: the scratch
// is reused across rounds and never cleared). The test comes after the
// starts walk and the vote after the gathers: a vote before the walk,
// which also skipped a quiet tile's walk, put the index and bit loads
// ahead of the walk's loads in every tile and made a dense K6 sweep 23%
// slower. tmark is zeroed once a host call; round r marks a live tile
// 2r + 2 and a quiet one 2r + 3, so no mark of an earlier round or call
// is read as this round's. The gate state is a kernel argument of its
// own and the gating a template parameter, so K3's and K4's pass
// compiles as before (its instructions differ only in order).
//
// K6's rule. Sweep r maps d_r to d_{r+1}[v] = min(d_r[v], min over (u, v)
// of f(d_r[u], w)), f one of none, add, incr (weights finite). Source u
// is active in sweep 0 of a call when d_0[u] != +inf (the seed pass), and
// in sweep r > 0 when sweep r - 1 lowered it (the finish sets the groups
// of the rows that moved). Claim: for an inactive u and every edge
// (u, v), f(d_r[u], w) >= d_r[v], so dropping the edge leaves
// min(d_r[v], ...) and the change count equal bit for bit (values and
// weights carry no -0.0). By induction over r: in sweep 0, f(+inf, w) =
// +inf. In sweep r > 0, u was not lowered, so d_r[u] = d_{r-1}[u]; if u
// was read in sweep r - 1, that sweep took f(d_{r-1}[u], w) into d_r[v];
// if not, it was inactive, and the claim for r - 1 gives f(d_{r-1}[u], w)
// >= d_{r-1}[v] >= d_r[v]. The first sweep from one seed gathers only its
// group's edges.
//
// K9's rules. (1) A group is active when one of its vertices has gated
// != 0. Every other gated value is exactly +0.0 and every partial is a
// sum of non-negative floats, so leaving an addend out and adding the
// identity +0.0 are the same bits: the sums equal the ungated pass's,
// i.e. K3 sum/none over gated. (2) Only live rows read a total: forward
// the open rows (lab == +inf), backward the ring rows (lab == t). The gate
// marks the tiles of every live row with in-edges live; pass 1 leaves
// every other tile at once, before loading an index. Every tile a live
// row spans is live, so no total it reads comes from a skipped tile.
// Levels past the frontier and the deep and shallow rings then cost
// their two V-wide passes.
//
// Bound on the H100, gated: the indices and weights of the active
// sources' edges and the V-wide passes (gate or seed, finish: about 20
// MB at 2^20 vertices). What holds it: every live tile still streams its
// indices and walks its starts (K3's pass with every gather hitting L1
// takes 0.23 ms at rmat n20 e32), one source's out-edges reach most
// tiles of a scale-free graph, and in a sweep that lowered most vertices
// every group is active, so it costs a full pass. Only the live-tile
// skip (K9) removes whole tiles.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                   // edges a thread in pass 1
static_assert(kItems % 4 == 0, "16-byte loads of 4 edges");
constexpr int kTile = kThreads * kItems;    // edges a block in pass 1
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 16;
constexpr unsigned kFull = 0xffffffffu;
// The gated passes' source groups: kGroupWords words of bits, one word a
// lane of a warp, each bit 2^gshift consecutive vertices.
constexpr int kGroupWords = 32;
constexpr int64_t kGroups = 32 * kGroupWords;

// Reduction and edge function codes, shared with ops/pull2.py.
enum Op : int { kSum = 0, kMin = 1 };
enum Fn : int { kNone = 0, kAdd = 1, kMul = 2, kIncr = 3 };
// Weight streams: none, one per CSC edge ("val"), one per source
// vertex gathered by csc_indices ("wpr", 1/out-degree).
enum Weights : int { kNoWeights = 0, kPerEdge = 1, kPerSource = 2 };
// Gating of pass 1 and pass 2 (see the file comment): none (K3, K4),
// source bits (K6), source bits and live tiles (K9).
enum Gate : int { kUngated = 0, kSources = 1, kLiveTiles = 2 };

struct PullArgs {
  const float* values;
  const int32_t* indices;   // csc_indices: source of each CSC edge
  const int32_t* offsets;   // csc_offsets: (rows + 1,)
  const float* weights;
  int64_t num_edges;
  int64_t rows;             // v_pad
  int64_t n_values;         // length of values (and of per-source
                            // weights): rows, or more for a shard's
                            // compact table (K3)
  int op, fn, wkind;
  int32_t* tile_rows;       // (ntiles + 1,) scratch: row of each tile's
                            // first edge, then rows
  float* rowval;            // (rows,) scratch
  float* head;              // (ntiles,) scratch
  float* tail;              // (ntiles,) scratch
  float* vscratch;          // (n_values,) scratch: folded per-source values
};

// A round of a gated pass (K6, K9).
struct GateArgs {
  uint32_t* groups;         // (kGroupWords,) this round's active groups
  uint32_t* next_groups;    // (kGroupWords,) the next round's
  int gshift;               // a group is 2^gshift vertices
  int32_t* tmark;           // (ntiles,) live and quiet marks
  int32_t live_mark, quiet_mark;  // this round's
};

__host__ __device__ __forceinline__ int64_t num_tiles(int64_t num_edges) {
  return (num_edges + kTile - 1) / kTile;
}

__device__ __forceinline__ float identity(int op) {
  return op == kSum ? 0.0f : __int_as_float(0x7f800000);  // +inf
}

// The explicit _rn intrinsics keep nvcc from contracting a multiply and
// an add into one FMA, so each value is rounded where the plain PyTorch
// version rounds it.
__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == kSum ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float apply_fn(int fn, float x, float w) {
  switch (fn) {
    case kAdd: return __fadd_rn(x, w);
    case kMul: return __fmul_rn(x, w);
    case kIncr: return __fadd_rn(x, 1.0f);
    default: return x;
  }
}

// vscratch[u] = f(values[u], weights[u]) for per-source weights, over
// the whole value table.
__global__ void fold_per_source_kernel(PullArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < a.n_values; u += stride) {
    a.vscratch[u] = apply_fn(a.fn, __ldg(a.values + u), __ldg(a.weights + u));
  }
}

__device__ __forceinline__ void emit(const PullArgs& a, int64_t t,
                                     int32_t first_row, int32_t row,
                                     bool last, float val) {
  a.rowval[row] = val;
  if (row == first_row) a.head[t] = val;
  if (last) a.tail[t] = val;
}

// Whether edge k of a thread reads its source: always ungated, else when
// bit k of the thread's activity word is set.
template <int G>
__device__ __forceinline__ bool on(unsigned act, int k) {
  if constexpr (G == kUngated) {
    return true;
  } else {
    return (act >> k) & 1u;
  }
}

// Pass 1: per-tile segmented reduction (see the file comment).
template <int G>
__device__ __forceinline__ void pull_tiles(const PullArgs& a,
                                           const GateArgs& g) {
  __shared__ __align__(16) int32_t starts[kTile];  // row starting here, or -1
  __shared__ float warp_val[kWarps];
  __shared__ int32_t warp_flag[kWarps];
  __shared__ int32_t warp_row[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = tid * kItems;
  const int64_t ntiles = num_tiles(a.num_edges);
  const float ident = identity(a.op);
  const bool per_edge = a.wkind == kPerEdge;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.indices) |
        (per_edge ? reinterpret_cast<uintptr_t>(a.weights) : 0)) & 15) == 0;
  // Gated: lane i holds word i of this round's group bits; block 0 clears
  // the next round's, which nothing reads in this round.
  uint32_t gword = 0;
  if constexpr (G != kUngated) {
    gword = __ldg(g.groups + lane);
    if (blockIdx.x == 0 && tid < kGroupWords) g.next_groups[tid] = 0u;
  }
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    if constexpr (G == kLiveTiles) {
      if (g.tmark[t] != g.live_mark) continue;  // no live row reads it
    }
    const int64_t lo = t * kTile;
    const int len = (int)(a.num_edges - lo < kTile ? a.num_edges - lo : kTile);
    const int n = len - p0 < 0 ? 0 : (len - p0 < kItems ? len - p0 : kItems);
    const bool whole = n == kItems && aligned;
    // This thread's sources and weights, 16 bytes a load.
    int32_t src[kItems];
    float w[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) w[k] = 0.0f;
    if (whole) {
      const int4* ip = reinterpret_cast<const int4*>(a.indices + lo + p0);
      const float4* wp = reinterpret_cast<const float4*>(a.weights + lo + p0);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const int4 i4 = __ldcs(ip + q);
        src[4 * q] = i4.x;
        src[4 * q + 1] = i4.y;
        src[4 * q + 2] = i4.z;
        src[4 * q + 3] = i4.w;
        if (per_edge) {
          const float4 w4 = __ldcs(wp + q);
          w[4 * q] = w4.x;
          w[4 * q + 1] = w4.y;
          w[4 * q + 2] = w4.z;
          w[4 * q + 3] = w4.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        src[k] = k < n ? __ldcs(a.indices + lo + p0 + k) : 0;
        if (per_edge && k < n) w[k] = __ldcs(a.weights + lo + p0 + k);
      }
    }
    // Mark the rows that start inside the tile. tile_rows[t] holds edge
    // lo, so every later row starts after lo; tile_rows[t + 1] holds edge
    // lo + kTile (or is rows after the last tile).
    const int32_t first_row = a.tile_rows[t];
    const int64_t end_row = a.tile_rows[t + 1];
    int4* mine = reinterpret_cast<int4*>(starts + p0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) mine[q] = make_int4(-1, -1, -1, -1);
    __syncthreads();
    for (int64_t r = first_row + 1 + tid; r <= end_row && r < a.rows;
         r += kThreads) {
      const int32_t s = __ldg(a.offsets + r);
      if (s < lo + len && __ldg(a.offsets + r + 1) > s) {
        starts[s - lo] = (int32_t)r;
      }
    }
    // Gated: bit k set when edge k's source is active. Tested after the
    // starts walk, so that the walk's loads go out with the index loads
    // as in the ungated pass (a warp issues in order, and a bit's address
    // waits for its index).
    unsigned act = 0;
    if constexpr (G != kUngated) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int grp = src[k] >> g.gshift;
        const uint32_t word = __shfl_sync(kFull, gword, grp >> 5);
        act |= (k < n ? (word >> (grp & 31)) & 1u : 0u) << k;
      }
    }
    // All gathers in flight before any is used.
    float x[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      x[k] = k < n && on<G>(act, k) ? __ldg(a.values + src[k]) : ident;
    }
    if constexpr (G == kUngated) {
      __syncthreads();
    } else {
      // The vote, at the barrier the scan needs anyway: a quiet tile
      // leaves identity head and tail partials and its mark, and skips
      // the scan and the emits.
      if (!__syncthreads_or(act != 0)) {
        if (tid == 0) {
          a.head[t] = ident;
          a.tail[t] = ident;
          g.tmark[t] = g.quiet_mark;
        }
        continue;
      }
    }
    int32_t st[kItems];
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 s4 = mine[q];
      st[4 * q] = s4.x;
      st[4 * q + 1] = s4.y;
      st[4 * q + 2] = s4.z;
      st[4 * q + 3] = s4.w;
    }
    // The thread's last run: its partial, whether it starts in this
    // thread (always for thread 0, the tile's edge), and the row of the
    // last start in the thread (-1 if none).
    float trail = ident;
    bool flag = tid == 0;
    int32_t last_start = -1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < n) {
        if (on<G>(act, k)) x[k] = apply_fn(a.fn, x[k], w[k]);
        if (st[k] >= 0) {
          trail = ident;
          flag = true;
          last_start = st[k];
        }
        trail = combine(a.op, trail, x[k]);
      }
    }
    // Block-wide inclusive scans over the threads, in a fixed tree: a
    // segmented combine of the partials (a flag starts a segment) and a
    // max of the rows.
    float v = trail;
    bool f = flag;
    int32_t m = last_start;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ov = __shfl_up_sync(kFull, v, d);
      const int of = __shfl_up_sync(kFull, (int)f, d);
      const int32_t om = __shfl_up_sync(kFull, m, d);
      if (lane >= d) {
        if (!f) v = combine(a.op, ov, v);
        f = f || of;
        m = om > m ? om : m;
      }
    }
    if (lane == 31) {
      warp_val[warp] = v;
      warp_flag[warp] = f;
      warp_row[warp] = m;
    }
    __syncthreads();
    // The scan up to the end of the previous warp, in warp order.
    float pv = ident;
    int32_t pm = -1;
    for (int j = 0; j < warp; ++j) {
      pv = warp_flag[j] ? warp_val[j] : combine(a.op, pv, warp_val[j]);
      pm = warp_row[j] > pm ? warp_row[j] : pm;
    }
    if (!f) v = combine(a.op, pv, v);
    m = pm > m ? pm : m;
    // Exclusive: the value and row this thread continues.
    float carry = __shfl_up_sync(kFull, v, 1);
    int32_t row = __shfl_up_sync(kFull, m, 1);
    if (lane == 0) {
      carry = pv;
      row = pm;
    }
    if (row < 0) row = first_row;
    if (n > 0) {
      float acc = tid > 0 && st[0] < 0 ? carry : ident;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (k < n) {
          if (st[k] >= 0) {
            if (k > 0) emit(a, t, first_row, row, false, acc);
            row = st[k];
            acc = ident;
          }
          acc = combine(a.op, acc, x[k]);
        }
      }
      // The last run closes here if the next position starts a row or
      // ends the tile.
      const int pe = p0 + n;
      if (pe == len || starts[pe] >= 0) {
        emit(a, t, first_row, row, pe == len, acc);
      }
    }
    __syncthreads();  // starts and the warp totals are reused
  }
}

// K3's and K4's pass 1, and the gated one of K6 and K9.
__global__ void __launch_bounds__(kThreads) pull_tiles_kernel(PullArgs a) {
  pull_tiles<kUngated>(a, GateArgs{});
}

template <int G>
__global__ void __launch_bounds__(kThreads)
gated_tiles_kernel(PullArgs a, GateArgs g) {
  pull_tiles<G>(a, g);
}

// Pass 2: per-row totals, then out[v] = init[v] (+) total; K6 also
// counts the rows that changed.
struct FinishArgs {
  const float* init;        // may be null
  float* out;
  // One counter for this sweep (may be null): the rows where out < init.
  int32_t* changed;
};

// The bits, in their word (group_word), of the groups of 2^gshift rows
// among base .. base + 31 (base a multiple of 32) that hold a row set in
// m: the groups of 32 rows lie in one word.
__device__ __forceinline__ uint32_t group_bits(int gshift, int64_t base,
                                               unsigned m) {
  if (m == 0) return 0u;
  const int64_t g0 = base >> gshift;
  unsigned bits = 1u;
  if (gshift < 5) {
    const int span = 1 << gshift;
    bits = 0u;
    for (int j = 0; j < 32 / span; ++j) {
      if ((m >> (j * span)) & ((1u << span) - 1u)) bits |= 1u << j;
    }
  }
  return bits << (g0 & 31);
}

__device__ __forceinline__ int64_t group_word(int gshift, int64_t base) {
  return (base >> gshift) >> 5;
}

// Gated, a quiet tile left identity head and tail partials but no rowval,
// so a row inside one quiet tile reads the identity.
template <int G>
__device__ __forceinline__ float row_total(const PullArgs& a,
                                           const GateArgs& g, int64_t v) {
  const int32_t lo = __ldg(a.offsets + v);
  const int32_t hi = __ldg(a.offsets + v + 1);
  if (hi <= lo) return identity(a.op);
  const int64_t c0 = lo / kTile;
  const int64_t c1 = (hi - 1) / kTile;
  if (c0 == c1) {
    if constexpr (G != kUngated) {
      if (g.tmark[c0] == g.quiet_mark) return identity(a.op);
    }
    return a.rowval[v];
  }
  float acc = a.tail[c0];
#pragma unroll 8
  for (int64_t c = c0 + 1; c < c1; ++c) acc = combine(a.op, acc, a.head[c]);
  return combine(a.op, acc, a.head[c1]);
}

template <int G>
__device__ __forceinline__ void pull_finish(const PullArgs& a,
                                            const FinishArgs& f,
                                            const GateArgs& g) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // The loop runs per warp (base is warp-uniform and a multiple of 32),
  // so every lane reaches the ballot below, and a warp's rows are one
  // word of the source bits.
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    bool moved = false;
    if (v < a.rows) {
      float acc = row_total<G>(a, g, v);
      if (f.init != nullptr) {
        const float old = __ldg(f.init + v);
        acc = combine(a.op, old, acc);
        moved = acc < old;
      }
      f.out[v] = acc;
    }
    // Integer counts are exact whatever the order of the atomics: one per
    // warp, of the warp's changed lanes. K6's rows that moved make their
    // groups the next sweep's active ones.
    if constexpr (G == kSources) {
      const unsigned m = __ballot_sync(kFull, moved);
      if (lane == 0 && m != 0) {
        atomicAdd(f.changed, (int)__popc(m));
        atomicOr(g.next_groups + group_word(g.gshift, base),
                 group_bits(g.gshift, base, m));
      }
    } else if (f.changed != nullptr) {
      const unsigned m = __ballot_sync(kFull, moved);
      if (lane == 0 && m != 0) atomicAdd(f.changed, (int)__popc(m));
    }
  }
}

__global__ void pull_finish_kernel(PullArgs a, FinishArgs f) {
  pull_finish<kUngated>(a, f, GateArgs{});
}

__global__ void gated_finish_kernel(PullArgs a, FinishArgs f, GateArgs g) {
  pull_finish<kSources>(a, f, g);
}

// K4's pass 2, a round: rank' = v < num_nodes ? reset + damping * total
// : 0, the count of |rank' - rank| > threshold, and, where folded is not
// null, the next round's folded values rank' * weights (fold_per_source's
// product).
struct PowerFinish {
  const float* rank_in;
  float* out;
  float* folded;
  int32_t* changed;
  int64_t num_nodes;
  float damping, reset, threshold;
};

__global__ void power_finish_kernel(PullArgs a, PowerFinish f) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int32_t moves = 0;  // lane 0's: the warp's
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    bool moved = false;
    if (v < a.rows) {
      const float acc = row_total<kUngated>(a, GateArgs{}, v);
      const float fresh =
          v < f.num_nodes ? __fadd_rn(f.reset, __fmul_rn(f.damping, acc))
                          : 0.0f;
      moved = fabsf(__fsub_rn(fresh, __ldg(f.rank_in + v))) > f.threshold;
      f.out[v] = fresh;
      if (f.folded != nullptr) {
        f.folded[v] = __fmul_rn(fresh, __ldg(a.weights + v));
      }
    }
    moves += __popc(__ballot_sync(kFull, moved));
  }
  // Integer counts are exact in any order: a warp's, then the block's,
  // then one atomic a block.
  __shared__ int32_t block_moves;
  if (threadIdx.x == 0) block_moves = 0;
  __syncthreads();
  if (lane == 0 && moves != 0) atomicAdd(&block_moves, moves);
  __syncthreads();
  if (threadIdx.x == 0 && block_moves != 0) atomicAdd(f.changed, block_moves);
}

// K6's first sweep of a call: a group is active when one of its vertices
// is not +inf in init (a superset of the finite entries, as the JAX act0).
__global__ void seed_groups_kernel(PullArgs a, GateArgs g,
                                   const float* init) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    const bool seeded = v < a.rows && init[v] != __int_as_float(0x7f800000);
    const unsigned m = __ballot_sync(kFull, seeded);
    if (lane == 0 && m != 0) {
      atomicOr(g.groups + group_word(g.gshift, base),
               group_bits(g.gshift, base, m));
    }
  }
}

unsigned int blocks_for(int64_t threads) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

bool valid_args(const PullArgs& a, int tile) {
  return tile == kTile && a.rows > 0 && a.n_values > 0 &&
         (a.op == kSum || a.op == kMin) && a.fn >= kNone && a.fn <= kIncr &&
         a.wkind >= kNoWeights && a.wkind <= kPerSource &&
         ((a.fn == kAdd || a.fn == kMul) == (a.wkind != kNoWeights));
}

// Pass 1's share of an SM's 228 KB of shared memory and L1, in percent
// (a hint the driver rounds up to a size it offers): 32 KB, three
// blocks' tiles, the rest left to L1, which holds the hot part of the
// gathered values.
constexpr int kCarveout = 14;

// Once per host call: the tile rows, which do not change between rounds,
// and, once a device, the carveout of every variant of pass 1.
void launch_tile_rows(const PullArgs& a, cudaStream_t s) {
  static bool carved[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64 &&
      !carved[dev]) {
    for (const void* k : {(const void*)pull_tiles_kernel,
                          (const void*)gated_tiles_kernel<kSources>,
                          (const void*)gated_tiles_kernel<kLiveTiles>}) {
      cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           kCarveout);
    }
    carved[dev] = true;
  }
  csc_tile_rows_kernel<kTile><<<blocks_for(a.rows), kThreads, 0, s>>>(
      a.offsets, a.rows, a.num_edges, a.tile_rows);
}

// The group size of a gated call: the least 2^gshift that puts every
// vertex in one of kGroups groups.
int group_shift(int64_t rows) {
  int s = 0;
  while (((rows - 1) >> s) >= kGroups) ++s;
  return s;
}

// A gated host call: no tile carries a mark of its rounds yet, round 0
// has no active group, and the groups cover the rows. tmark: (ntiles,);
// gbuf: (2, kGroupWords), round r reading half r % 2 and clearing the
// other half for round r + 1.
GateArgs gate_call(const PullArgs& a, void* tmark, void* gbuf,
                   cudaStream_t s) {
  GateArgs g = {};
  g.tmark = (int32_t*)tmark;
  g.groups = (uint32_t*)gbuf;
  g.gshift = group_shift(a.rows);
  const int64_t ntiles = num_tiles(a.num_edges);
  if (ntiles > 0) cudaMemsetAsync(g.tmark, 0, ntiles * sizeof(int32_t), s);
  cudaMemsetAsync(g.groups, 0, kGroupWords * sizeof(uint32_t), s);
  return g;
}

// Round r of a gated call: its marks and its half of the group bits.
GateArgs gate_round(const GateArgs& call, int r) {
  GateArgs g = call;
  g.live_mark = 2 * r + 2;
  g.quiet_mark = 2 * r + 3;
  g.groups = call.groups + (r % 2) * kGroupWords;
  g.next_groups = call.groups + ((r + 1) % 2) * kGroupWords;
  return g;
}

unsigned int tile_blocks(int64_t num_edges) {
  const int64_t ntiles = num_tiles(num_edges);
  return (unsigned int)(ntiles < kMaxBlocks ? ntiles : kMaxBlocks);
}

// Per-source weights: fold them into vscratch and pull that with f = none.
void fold_weights(PullArgs& a, cudaStream_t s) {
  if (a.wkind == kPerSource) {
    fold_per_source_kernel<<<blocks_for(a.n_values), kThreads, 0, s>>>(a);
    a.values = a.vscratch;
    a.fn = kNone;
    a.wkind = kNoWeights;
  }
}

void launch_pull(PullArgs a, const FinishArgs& f, cudaStream_t s) {
  fold_weights(a, s);
  if (a.num_edges > 0) {
    pull_tiles_kernel<<<tile_blocks(a.num_edges), kThreads, 0, s>>>(a);
  }
  pull_finish_kernel<<<blocks_for(a.rows), kThreads, 0, s>>>(a, f);
}

// K9's gate (see the file comment): gated[v] for the level, the source
// bits (gated != 0) and the live marks of the tiles of every live row.
// want is d - 1 forward, t + 1 backward; level is d or t.
__global__ void brandes_gate_kernel(PullArgs a, GateArgs g, const float* lab,
                                    const float* sig, const float* delta,
                                    float* gated, float want, float level,
                                    bool fwd) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    float x = 0.0f;
    if (v < a.rows) {
      const float l = lab[v];
      if (l == want) {
        x = fwd ? sig[v]
                : __fdiv_rn(__fadd_rn(1.0f, delta[v]), fmaxf(sig[v], 1e-30f));
      }
      gated[v] = x;
      if (fwd ? l == __int_as_float(0x7f800000) : l == level) {
        const int32_t lo = __ldg(a.offsets + v);
        const int32_t hi = __ldg(a.offsets + v + 1);
        if (hi > lo) {
          for (int64_t c = lo / kTile; c <= (hi - 1) / kTile; ++c) {
            g.tmark[c] = g.live_mark;
          }
        }
      }
    }
    const unsigned m = __ballot_sync(kFull, x != 0.0f);
    if (lane == 0 && m != 0) {
      atomicOr(g.groups + group_word(g.gshift, base),
               group_bits(g.gshift, base, m));
    }
  }
}

// K9's finish: the level's epilogue over the row totals of pass 1, and
// the count of rows it labelled (forward) or updated (backward). Only
// the live rows read a total.
__global__ void brandes_finish_kernel(PullArgs a, GateArgs g, float* lab,
                                      float* sig, float* delta, float level,
                                      bool fwd, int32_t* count) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    bool hit = false;
    if (v < a.rows) {
      const float l = lab[v];
      if (fwd && l == __int_as_float(0x7f800000)) {
        const float s = __fadd_rn(sig[v], row_total<kLiveTiles>(a, g, v));
        sig[v] = s;
        if (s > 0.0f) {
          lab[v] = level;
          hit = true;
        }
      } else if (!fwd && l == level) {
        delta[v] = __fmul_rn(
            sig[v], __fadd_rn(delta[v], row_total<kLiveTiles>(a, g, v)));
        hit = true;
      }
    }
    const unsigned m = __ballot_sync(kFull, hit);
    if (lane == 0 && m != 0) atomicAdd(count, (int)__popc(m));
  }
}

PullArgs make_args(const void* values, const void* indices,
                   const void* offsets, int64_t num_edges, int64_t rows,
                   const void* weights, int wkind, int op, int fn,
                   void* tile_rows, void* rowval, void* head, void* tail,
                   void* vscratch) {
  PullArgs a = {};
  a.values = (const float*)values;
  a.indices = (const int32_t*)indices;
  a.offsets = (const int32_t*)offsets;
  a.weights = (const float*)weights;
  a.num_edges = num_edges;
  a.rows = rows;
  a.n_values = rows;
  a.op = op;
  a.fn = fn;
  a.wkind = wkind;
  a.tile_rows = (int32_t*)tile_rows;
  a.rowval = (float*)rowval;
  a.head = (float*)head;
  a.tail = (float*)tail;
  a.vscratch = (float*)vscratch;
  return a;
}

}  // namespace

extern "C" {

// K3. tile: kTile (the wrapper's PULL_TILE). values (and per-source
// weights) hold n_values entries: rows for a graph, S + p * ghost_cap
// for a shard's compact table, whose ghost slots no row owns. Scratch:
// tile_rows (ntiles + 1,) int32; rowval (rows,), vscratch (n_values,),
// head and tail (ntiles,) float32, with ntiles = ceil(num_edges / tile).
// init may be null.
int gr_pull_reduce(const void* values, const void* indices,
                   const void* offsets, int64_t num_edges, int64_t rows,
                   int64_t n_values, const void* weights, int wkind, int op,
                   int fn, const void* init, int tile, void* tile_rows,
                   void* rowval, void* head, void* tail, void* vscratch,
                   void* out, void* stream) {
  PullArgs a = make_args(values, indices, offsets, num_edges, rows,
                         weights, wkind, op, fn, tile_rows, rowval, head,
                         tail, vscratch);
  a.n_values = n_values;
  if (!valid_args(a, tile)) return (int)cudaErrorInvalidValue;
  FinishArgs f = {};
  f.init = (const float*)init;
  f.out = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  launch_tile_rows(a, s);
  launch_pull(a, f, s);
  return (int)cudaGetLastError();
}

// K4. Round r reads init (r = 0) or the previous round's buffer and
// writes ping (r even) or pong (r odd), so the last round lands in ping
// when iters is odd and in pong when it is even. changed: (iters,) int32,
// zeroed by the caller. Scratch as for gr_pull_reduce. Per-source
// weights are folded into vscratch once; each round's finish but the
// last folds the next round's.
int gr_pull_power_iters(const void* init, void* ping, void* pong,
                        const void* indices, const void* offsets,
                        int64_t num_edges, int64_t rows, int64_t num_nodes,
                        const void* weights, int wkind, float damping,
                        float reset, float threshold, int iters, int tile,
                        void* tile_rows, void* rowval, void* head, void* tail,
                        void* vscratch, void* changed, void* stream) {
  PullArgs a = make_args(init, indices, offsets, num_edges, rows, weights,
                         wkind, kSum, kMul, tile_rows, rowval, head, tail,
                         vscratch);
  if (!valid_args(a, tile) || iters < 1) return (int)cudaErrorInvalidValue;
  PowerFinish f = {};
  f.num_nodes = num_nodes;
  f.damping = damping;
  f.reset = reset;
  f.threshold = threshold;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool per_source = wkind == kPerSource;
  launch_tile_rows(a, s);
  fold_weights(a, s);  // per-source: a now pulls vscratch with f = none
  const float* in = (const float*)init;
  for (int r = 0; r < iters; ++r) {
    float* out = (float*)(r % 2 == 0 ? ping : pong);
    if (!per_source) a.values = in;
    f.rank_in = in;
    f.out = out;
    f.folded = per_source && r + 1 < iters ? a.vscratch : nullptr;
    f.changed = (int32_t*)changed + r;
    if (num_edges > 0) {
      pull_tiles_kernel<<<tile_blocks(num_edges), kThreads, 0, s>>>(a);
    }
    power_finish_kernel<<<blocks_for(rows), kThreads, 0, s>>>(a, f);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    in = out;
  }
  return 0;
}

// K6. Sweep r reads init (r = 0) or the previous sweep's buffer and
// writes ping (r even) or pong (r odd), so the last sweep lands in ping
// when sweeps is odd and in pong when it is even. fn: none, add or incr
// (with the matching weights). changed: (sweeps,) int32, zeroed by the
// caller. Scratch as for gr_pull_reduce, and tmark (ntiles,) int32 and
// active (ceil(rows / 32),) uint32. Pass 1 is gated by the sources that
// are not +inf in init (sweep 0) or that the previous sweep lowered.
int gr_pull_min_sweeps(const void* init, void* ping, void* pong,
                       const void* indices, const void* offsets,
                       int64_t num_edges, int64_t rows, const void* weights,
                       int wkind, int fn, int sweeps, int tile,
                       void* tile_rows, void* rowval, void* head, void* tail,
                       void* vscratch, void* tmark, void* groups,
                       void* changed, void* stream) {
  PullArgs a = make_args(init, indices, offsets, num_edges, rows, weights,
                         wkind, kMin, fn, tile_rows, rowval, head, tail,
                         vscratch);
  if (!valid_args(a, tile) || sweeps < 1 || fn == kMul) {
    return (int)cudaErrorInvalidValue;
  }
  FinishArgs f = {};
  const cudaStream_t s = (cudaStream_t)stream;
  launch_tile_rows(a, s);
  const GateArgs call = gate_call(a, tmark, groups, s);
  seed_groups_kernel<<<blocks_for(rows), kThreads, 0, s>>>(
      a, gate_round(call, 0), (const float*)init);
  const float* in = (const float*)init;
  for (int r = 0; r < sweeps; ++r) {
    float* out = (float*)(r % 2 == 0 ? ping : pong);
    const GateArgs g = gate_round(call, r);
    PullArgs b = a;
    b.values = in;
    fold_weights(b, s);
    f.init = in;
    f.out = out;
    f.changed = (int32_t*)changed + r;
    if (num_edges > 0) {
      gated_tiles_kernel<kSources><<<tile_blocks(num_edges), kThreads, 0,
                                     s>>>(b, g);
    }
    gated_finish_kernel<<<blocks_for(rows), kThreads, 0, s>>>(b, f, g);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    in = out;
  }
  return 0;
}

// K9. fwd != 0: levels d = level0 .. level0 + levels - 1 update lab and
// sig in place (delta may be null). fwd == 0: rings t = level0 down to
// level0 - levels + 1 update delta in place, reading lab and sig.
// counts: (levels,) int32, zeroed by the caller. Scratch: gated as
// vscratch, tmark and active as for gr_pull_min_sweeps, the rest as for
// gr_pull_reduce.
int gr_brandes_levels(void* lab, void* sig, void* delta, const void* indices,
                      const void* offsets, int64_t num_edges, int64_t rows,
                      int fwd, int level0, int levels, int tile,
                      void* tile_rows, void* gated, void* rowval, void* head,
                      void* tail, void* tmark, void* groups, void* counts,
                      void* stream) {
  PullArgs a = make_args(gated, indices, offsets, num_edges, rows, nullptr,
                         kNoWeights, kSum, kNone, tile_rows, rowval, head,
                         tail, nullptr);
  if (!valid_args(a, tile) || levels < 1 || (!fwd && delta == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  launch_tile_rows(a, s);
  const GateArgs call = gate_call(a, tmark, groups, s);
  const unsigned int vblocks = blocks_for(rows);
  for (int r = 0; r < levels; ++r) {
    const int level = fwd ? level0 + r : level0 - r;
    const GateArgs g = gate_round(call, r);
    brandes_gate_kernel<<<vblocks, kThreads, 0, s>>>(
        a, g, (const float*)lab, (const float*)sig, (const float*)delta,
        (float*)gated, (float)(fwd ? level - 1 : level + 1), (float)level,
        fwd != 0);
    if (num_edges > 0) {
      gated_tiles_kernel<kLiveTiles><<<tile_blocks(num_edges), kThreads, 0,
                                       s>>>(a, g);
    }
    brandes_finish_kernel<<<vblocks, kThreads, 0, s>>>(
        a, g, (float*)lab, (float*)sig, (float*)delta, (float)level,
        fwd != 0, (int32_t*)counts + r);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
