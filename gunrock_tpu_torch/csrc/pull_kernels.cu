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
// that depends only on the graph and on the chunk size, never on
// scheduling.
//
// Load balance. R-MAT hub rows hold over 10^5 in-edges, so work is cut
// by edges, not by rows. Pass 1 gives each warp one chunk of `chunk`
// consecutive CSC edges (a multiple of 32). The warp walks its chunk 32
// edges at a time: lane l reads edge e = base + l (its source u =
// csc_indices[e] and its row csc_edge_dst[e], both coalesced), computes
// f(values[u], w), and a 5-step shuffle reduce combines lanes of the
// same row toward the first lane of each run. A warp-uniform carry joins
// runs across the 32-edge steps. Each closed run (row, value) goes to
// rowval[row]; the chunk's first run also goes to head[chunk] and its
// last run to tail[chunk]. Pass 2 gives one thread to each row: a row
// whose edges lie in one chunk reads rowval (written by that chunk
// alone); a row that spans chunks c0..c1 combines tail[c0], head[c0+1..
// c1-1] (whole chunks of the row) and head[c1] in chunk order. Rows that
// span chunks also get rowval writes from several warps; nothing reads
// those.
//
// Per-source weights. With the "wpr" stream, f(values[u], w[u]) depends
// on the source alone, so a V-sized pass folds it into one value a
// vertex first (vscratch) and pass 1 pulls that with f = none: one
// random gather an edge instead of two. Each folded value is the same
// float32 result the per-edge f would give, so the sums do not change.
//
// Bound on the H100: 8 bytes an edge streamed from HBM (csc_indices and
// csc_edge_dst: 485 MB at rmat n20 e32, 0.145 ms at 3.35 TB/s) plus one
// random 32-byte L2 sector per gathered value: about 1.9 GB of L2
// traffic a pull at that size.
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
// sig[u] where lab[u] == d - 1, else 0; K3's pass 1 sums gated over the
// CSC; the finish adds each undiscovered row's total into sig and labels
// it d where sig > 0. Backward ring t: the gate writes (1 + delta[v]) /
// max(sig[v], 1e-30) where lab[v] == t + 1; the finish sets delta[u] =
// sig[u] * (delta[u] + total) where lab[u] == t. Pulls reduce over
// in-edges, so the backward ring needs a symmetric edge set, as on the
// TPU. lab is float32 depth (+inf unreached): exact below 2^24 levels.
// The TPU kernel keeps lab, sig and delta in VMEM across levels and skips
// vertex groups with no nonzero gated entry; here they stay in HBM (12 MB
// at 2^20 vertices, mostly L2-resident) and every level streams every
// edge. Bound on the H100: a level streams csc_indices and csc_edge_dst
// (485 MB at rmat n20 e32, 0.145 ms at 3.35 TB/s) plus V-wide passes of
// about 20 MB. Skipping quiet chunks, as the TPU kernel does, is the next
// lever: a scale-free traversal's tail levels gate almost nothing.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

// Reduction and edge function codes, shared with ops/pull2.py.
enum Op : int { kSum = 0, kMin = 1 };
enum Fn : int { kNone = 0, kAdd = 1, kMul = 2, kIncr = 3 };
// Weight streams: none, one per CSC edge ("val"), one per source
// vertex gathered by csc_indices ("wpr", 1/out-degree).
enum Weights : int { kNoWeights = 0, kPerEdge = 1, kPerSource = 2 };

struct PullArgs {
  const float* values;
  const int32_t* indices;   // csc_indices: source of each CSC edge
  const int32_t* edge_dst;  // csc_edge_dst: row of each CSC edge
  const int32_t* offsets;   // csc_offsets: (rows + 1,)
  const float* weights;
  int64_t num_edges;
  int64_t rows;             // v_pad
  int chunk;                // edges per warp chunk, a multiple of 32
  int op, fn, wkind;
  float* rowval;            // (rows,) scratch
  float* head;              // (nchunks,) scratch
  float* tail;              // (nchunks,) scratch
  float* vscratch;          // (rows,) scratch: folded per-source values
};

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

// f of CSC edge e; per-source weights are folded before pass 1.
__device__ __forceinline__ float edge_value(const PullArgs& a, int64_t e) {
  const float x = __ldg(a.values + __ldg(a.indices + e));
  const float w = a.wkind == kPerEdge ? __ldg(a.weights + e) : 0.0f;
  return apply_fn(a.fn, x, w);
}

// vscratch[u] = f(values[u], weights[u]) for per-source weights.
__global__ void fold_per_source_kernel(PullArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < a.rows; u += stride) {
    a.vscratch[u] = apply_fn(a.fn, __ldg(a.values + u), __ldg(a.weights + u));
  }
}

__device__ __forceinline__ void emit(const PullArgs& a, int64_t c,
                                     int32_t first_row, int32_t last_row,
                                     int32_t row, float val) {
  a.rowval[row] = val;
  if (row == first_row) a.head[c] = val;
  if (row == last_row) a.tail[c] = val;
}

// Pass 1: per-chunk segmented reduction (see the file comment).
__global__ void pull_chunks_kernel(PullArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t nchunks = (a.num_edges + a.chunk - 1) / a.chunk;
  const float ident = identity(a.op);
  for (int64_t c = warp; c < nchunks; c += nwarps) {
    const int64_t lo = c * a.chunk;
    const int64_t hi =
        lo + a.chunk < a.num_edges ? lo + a.chunk : a.num_edges;
    const int32_t first_row = __ldg(a.edge_dst + lo);
    const int32_t last_row = __ldg(a.edge_dst + hi - 1);
    int32_t carry_row = -1;  // warp-uniform: the open run
    float carry = ident;
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t e = base + lane;
      const bool valid = e < hi;
      int32_t row = -1;      // tail lanes: a row no edge has
      float x = ident;
      if (valid) {
        row = __ldg(a.edge_dst + e);
        x = edge_value(a, e);
      }
      // Segmented suffix reduce: afterwards the first lane of each run
      // holds the run's value. Rows are nondecreasing along the CSC, so
      // equal rows at lanes l and l + d mean one run covers l..l + d.
      for (int d = 1; d < 32; d <<= 1) {
        const float ox = __shfl_down_sync(0xffffffffu, x, d);
        const int32_t orow = __shfl_down_sync(0xffffffffu, row, d);
        if (lane + d < 32 && orow == row) x = combine(a.op, x, ox);
      }
      const int32_t prev_row = __shfl_up_sync(0xffffffffu, row, 1);
      const bool is_head = valid && (lane == 0 || prev_row != row);
      const unsigned heads = __ballot_sync(0xffffffffu, is_head);
      const int last_head = 31 - __clz(heads);  // lane 0 is always a head
      // The first run continues the carry, or the carry closed at the
      // step boundary.
      if (lane == 0) {
        if (row == carry_row) {
          x = combine(a.op, carry, x);
        } else if (carry_row >= 0) {
          emit(a, c, first_row, last_row, carry_row, carry);
        }
      }
      // Every run but the last is closed.
      if (is_head && lane != last_head) {
        emit(a, c, first_row, last_row, row, x);
      }
      carry = __shfl_sync(0xffffffffu, x, last_head);
      carry_row = __shfl_sync(0xffffffffu, row, last_head);
    }
    if (lane == 0) emit(a, c, first_row, last_row, carry_row, carry);
  }
}

// Pass 2: per-row totals, then K3's out[v] = init[v] (+) total or K4's
// epilogue; K4 and K6 also count the rows that changed.
struct FinishArgs {
  const float* init;        // may be null
  float* out;
  // K4 epilogue (used when rank_in is not null).
  const float* rank_in;
  int64_t num_nodes;
  float damping, reset, threshold;
  // One counter for this round or sweep (may be null): K4 counts
  // |rank' - rank| > threshold, K6 the rows where out < init.
  int32_t* changed;
};

__device__ __forceinline__ float row_total(const PullArgs& a, int64_t v) {
  const int32_t lo = __ldg(a.offsets + v);
  const int32_t hi = __ldg(a.offsets + v + 1);
  if (hi <= lo) return identity(a.op);
  const int64_t c0 = lo / a.chunk;
  const int64_t c1 = (hi - 1) / a.chunk;
  if (c0 == c1) return a.rowval[v];
  float acc = a.tail[c0];
#pragma unroll 8
  for (int64_t c = c0 + 1; c < c1; ++c) acc = combine(a.op, acc, a.head[c]);
  return combine(a.op, acc, a.head[c1]);
}

__global__ void pull_finish_kernel(PullArgs a, FinishArgs f) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // The loop runs per warp (base is warp-uniform), so every lane reaches
  // the ballot below.
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    bool moved = false;
    if (v < a.rows) {
      float acc = row_total(a, v);
      if (f.rank_in == nullptr) {
        if (f.init != nullptr) {
          const float old = __ldg(f.init + v);
          acc = combine(a.op, old, acc);
          moved = acc < old;
        }
        f.out[v] = acc;
      } else {
        const float fresh =
            v < f.num_nodes ? __fadd_rn(f.reset, __fmul_rn(f.damping, acc))
                            : 0.0f;
        moved = fabsf(__fsub_rn(fresh, __ldg(f.rank_in + v))) > f.threshold;
        f.out[v] = fresh;
      }
    }
    if (f.changed != nullptr) {
      // Integer counts are exact whatever the order of the atomics: one
      // per warp, of the warp's changed lanes.
      const unsigned m = __ballot_sync(0xffffffffu, moved);
      if (lane == 0 && m != 0) atomicAdd(f.changed, (int)__popc(m));
    }
  }
}

unsigned int blocks_for(int64_t threads) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

bool valid_args(const PullArgs& a) {
  return a.chunk > 0 && a.chunk % 32 == 0 && a.rows > 0 &&
         (a.op == kSum || a.op == kMin) && a.fn >= kNone && a.fn <= kIncr &&
         a.wkind >= kNoWeights && a.wkind <= kPerSource &&
         ((a.fn == kAdd || a.fn == kMul) == (a.wkind != kNoWeights));
}

void launch_pull(PullArgs a, const FinishArgs& f, cudaStream_t s) {
  if (a.wkind == kPerSource) {
    fold_per_source_kernel<<<blocks_for(a.rows), kThreads, 0, s>>>(a);
    a.values = a.vscratch;
    a.fn = kNone;
    a.wkind = kNoWeights;
  }
  if (a.num_edges > 0) {
    const int64_t nchunks = (a.num_edges + a.chunk - 1) / a.chunk;
    pull_chunks_kernel<<<blocks_for(nchunks * 32), kThreads, 0, s>>>(a);
  }
  pull_finish_kernel<<<blocks_for(a.rows), kThreads, 0, s>>>(a, f);
}

// K9's gate: gated[v] for the level (see the file comment). want is d - 1
// forward, t + 1 backward.
__global__ void brandes_gate_kernel(int64_t rows, const float* lab,
                                    const float* sig, const float* delta,
                                    float* gated, float want, bool fwd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < rows;
       v += stride) {
    float g = 0.0f;
    if (lab[v] == want) {
      g = fwd ? sig[v]
              : __fdiv_rn(__fadd_rn(1.0f, delta[v]), fmaxf(sig[v], 1e-30f));
    }
    gated[v] = g;
  }
}

// K9's finish: the level's epilogue over the row totals of pass 1, and
// the count of rows it labelled (forward) or updated (backward).
__global__ void brandes_finish_kernel(PullArgs a, float* lab, float* sig,
                                      float* delta, float level, bool fwd,
                                      int32_t* count) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < a.rows; base += stride) {
    const int64_t v = base + lane;
    bool hit = false;
    if (v < a.rows) {
      const float l = lab[v];
      if (fwd && l == __int_as_float(0x7f800000)) {
        const float s = __fadd_rn(sig[v], row_total(a, v));
        sig[v] = s;
        if (s > 0.0f) {
          lab[v] = level;
          hit = true;
        }
      } else if (!fwd && l == level) {
        delta[v] = __fmul_rn(sig[v], __fadd_rn(delta[v], row_total(a, v)));
        hit = true;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && m != 0) atomicAdd(count, (int)__popc(m));
  }
}

PullArgs make_args(const void* values, const void* indices,
                   const void* edge_dst, const void* offsets,
                   int64_t num_edges, int64_t rows, const void* weights,
                   int wkind, int op, int fn, int chunk, void* rowval,
                   void* head, void* tail, void* vscratch) {
  PullArgs a;
  a.values = (const float*)values;
  a.indices = (const int32_t*)indices;
  a.edge_dst = (const int32_t*)edge_dst;
  a.offsets = (const int32_t*)offsets;
  a.weights = (const float*)weights;
  a.num_edges = num_edges;
  a.rows = rows;
  a.chunk = chunk;
  a.op = op;
  a.fn = fn;
  a.wkind = wkind;
  a.rowval = (float*)rowval;
  a.head = (float*)head;
  a.tail = (float*)tail;
  a.vscratch = (float*)vscratch;
  return a;
}

}  // namespace

extern "C" {

// K3. Scratch: rowval and vscratch (rows,), head and tail
// (ceil(num_edges / chunk),), float32 each. init may be null.
int gr_pull_reduce(const void* values, const void* indices,
                   const void* edge_dst, const void* offsets,
                   int64_t num_edges, int64_t rows, const void* weights,
                   int wkind, int op, int fn, const void* init, int chunk,
                   void* rowval, void* head, void* tail, void* vscratch,
                   void* out, void* stream) {
  const PullArgs a = make_args(values, indices, edge_dst, offsets, num_edges,
                               rows, weights, wkind, op, fn, chunk, rowval,
                               head, tail, vscratch);
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  FinishArgs f = {};
  f.init = (const float*)init;
  f.out = (float*)out;
  launch_pull(a, f, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K4. Round r reads init (r = 0) or the previous round's buffer and
// writes ping (r even) or pong (r odd), so the last round lands in ping
// when iters is odd and in pong when it is even. changed: (iters,) int32,
// zeroed by the caller. Scratch as for gr_pull_reduce.
int gr_pull_power_iters(const void* init, void* ping, void* pong,
                        const void* indices, const void* edge_dst,
                        const void* offsets, int64_t num_edges, int64_t rows,
                        int64_t num_nodes, const void* weights, int wkind,
                        float damping, float reset, float threshold,
                        int iters, int chunk, void* rowval, void* head,
                        void* tail, void* vscratch, void* changed,
                        void* stream) {
  PullArgs a = make_args(init, indices, edge_dst, offsets, num_edges, rows,
                         weights, wkind, kSum, kMul, chunk, rowval, head,
                         tail, vscratch);
  if (!valid_args(a) || iters < 1) return (int)cudaErrorInvalidValue;
  FinishArgs f = {};
  f.num_nodes = num_nodes;
  f.damping = damping;
  f.reset = reset;
  f.threshold = threshold;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)init;
  for (int r = 0; r < iters; ++r) {
    float* out = (float*)(r % 2 == 0 ? ping : pong);
    a.values = in;
    f.rank_in = in;
    f.out = out;
    f.changed = (int32_t*)changed + r;
    launch_pull(a, f, s);
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
// caller. Scratch as for gr_pull_reduce.
int gr_pull_min_sweeps(const void* init, void* ping, void* pong,
                       const void* indices, const void* edge_dst,
                       const void* offsets, int64_t num_edges, int64_t rows,
                       const void* weights, int wkind, int fn, int sweeps,
                       int chunk, void* rowval, void* head, void* tail,
                       void* vscratch, void* changed, void* stream) {
  PullArgs a = make_args(init, indices, edge_dst, offsets, num_edges, rows,
                         weights, wkind, kMin, fn, chunk, rowval, head, tail,
                         vscratch);
  if (!valid_args(a) || sweeps < 1) return (int)cudaErrorInvalidValue;
  FinishArgs f = {};
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)init;
  for (int r = 0; r < sweeps; ++r) {
    float* out = (float*)(r % 2 == 0 ? ping : pong);
    a.values = in;
    f.init = in;
    f.out = out;
    f.changed = (int32_t*)changed + r;
    launch_pull(a, f, s);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    in = out;
  }
  return 0;
}

// K9. fwd != 0: levels d = level0 .. level0 + levels - 1 update lab and
// sig in place (delta may be null). fwd == 0: rings t = level0 down to
// level0 - levels + 1 update delta in place, reading lab and sig.
// counts: (levels,) int32, zeroed by the caller. Scratch: gated and
// rowval (rows,), head and tail (ceil(num_edges / chunk),), float32 each.
int gr_brandes_levels(void* lab, void* sig, void* delta, const void* indices,
                      const void* edge_dst, const void* offsets,
                      int64_t num_edges, int64_t rows, int fwd, int level0,
                      int levels, int chunk, void* gated, void* rowval,
                      void* head, void* tail, void* counts, void* stream) {
  const PullArgs a = make_args(gated, indices, edge_dst, offsets, num_edges,
                               rows, nullptr, kNoWeights, kSum, kNone, chunk,
                               rowval, head, tail, nullptr);
  if (!valid_args(a) || levels < 1 || (!fwd && delta == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int vblocks = blocks_for(rows);
  for (int r = 0; r < levels; ++r) {
    const int level = fwd ? level0 + r : level0 - r;
    brandes_gate_kernel<<<vblocks, kThreads, 0, s>>>(
        rows, (const float*)lab, (const float*)sig, (const float*)delta,
        (float*)gated, (float)(fwd ? level - 1 : level + 1), fwd != 0);
    if (num_edges > 0) {
      const int64_t nchunks = (num_edges + chunk - 1) / chunk;
      pull_chunks_kernel<<<blocks_for(nchunks * 32), kThreads, 0, s>>>(a);
    }
    brandes_finish_kernel<<<vblocks, kThreads, 0, s>>>(
        a, (float*)lab, (float*)sig, (float*)delta, (float)level, fwd != 0,
        (int32_t*)counts + r);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
