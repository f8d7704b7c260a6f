// Hopper (sm_90a) kernels of the SSSP push round, behind a plain C
// interface that gunrock_tpu_torch/ops/kernels.py loads with ctypes
// (built with the other sources into one library by
// gunrock_tpu_torch/ops/_build.py).
//
// K5 sample_sorted:        out[i] = a[pos[i]] (and b[pos[i]]) for int32 or
//                          float32 arrays; positions outside the array read 0.
// K7 reduce_by_dst_sorted: min or sum over runs of equal sorted keys, the
//                          run ids and values compacted in ascending order,
//                          optionally only runs whose value is below aux.
// K8 scatter_sorted:       dense[ids[i]] = op(dense[ids[i]], vals[i]) for the
//                          first count lanes of a sorted unique id stream.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take). K7 zeroes its
// tile states with one cudaMemsetAsync before its one launch.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;

enum Op : int { kMin = 0, kSum = 1, kMax = 2, kSet = 3 };

// K5. Replaces gunrock_tpu/ops/pallas_kernels.py _sample_kernel (:594,
// sample_sorted :665) and _sample2_kernel (:686, sample_sorted2 :783).
// Those walk the sorted positions chunk by chunk through VMEM windows,
// because a TPU core cannot gather from HBM. Here a thread reads its
// positions directly. The gathers are independent, so what bounds a
// call is how many bytes are in flight: a thread takes kSampleQuads
// quads of 4 consecutive positions a trip (16-byte position loads, one
// int4 for int32 or two longlong2 for int64), issues every gather of
// the trip before it stores, and writes each quad's outputs with one
// 16-byte store an array. Neighbouring threads take neighbouring quads,
// so a warp's position loads and stores are each one contiguous run,
// and the sorted positions keep a warp's gathers close. The
// grid is a few blocks an SM striding over the quads; where a base is
// not 16-byte aligned, and for the last n % 4 positions, a thread takes
// one position at a time. Both dtypes are 32 bits wide and are moved as
// raw bits; positions outside the array read 0. Bound: the position
// read and the output writes stream (8-16 bytes a position); the
// gathered reads, sorted, touch each 32-byte sector about once.
constexpr int kSampleQuads = 2;

__device__ __forceinline__ void load_quad(const int32_t* p, int64_t (&o)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load_quad(const int64_t* p, int64_t (&o)[4]) {
  const longlong2 v0 = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 v1 = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  o[0] = v0.x; o[1] = v0.y; o[2] = v1.x; o[3] = v1.y;
}

__device__ __forceinline__ uint32_t gather(const uint32_t* __restrict__ a,
                                           int64_t len, int64_t p) {
  return p >= 0 && p < len ? __ldg(a + p) : 0u;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
sample_sorted_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int64_t len,
                     const I* __restrict__ pos, int64_t n,
                     uint32_t* __restrict__ out_a,
                     uint32_t* __restrict__ out_b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(pos) | reinterpret_cast<uintptr_t>(out_a)
        | reinterpret_cast<uintptr_t>(out_b)) & 15) == 0;
  const int64_t quads = aligned ? n / 4 : 0;
  for (int64_t q0 = first; q0 < quads; q0 += kSampleQuads * stride) {
    int64_t p[kSampleQuads][4];
#pragma unroll
    for (int k = 0; k < kSampleQuads; ++k) {
      const int64_t q = q0 + k * stride;
      if (q < quads) load_quad(pos + 4 * q, p[k]);
    }
    uint32_t va[kSampleQuads][4], vb[kSampleQuads][4];
#pragma unroll
    for (int k = 0; k < kSampleQuads; ++k) {
      if (q0 + k * stride < quads) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          va[k][j] = gather(a, len, p[k][j]);
          if (b != nullptr) vb[k][j] = gather(b, len, p[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSampleQuads; ++k) {
      const int64_t q = q0 + k * stride;
      if (q < quads) {
        reinterpret_cast<uint4*>(out_a)[q] =
            make_uint4(va[k][0], va[k][1], va[k][2], va[k][3]);
        if (b != nullptr) {
          reinterpret_cast<uint4*>(out_b)[q] =
              make_uint4(vb[k][0], vb[k][1], vb[k][2], vb[k][3]);
        }
      }
    }
  }
  for (int64_t i = 4 * quads + first; i < n; i += stride) {
    const int64_t p = (int64_t)pos[i];
    out_a[i] = gather(a, len, p);
    if (b != nullptr) out_b[i] = gather(b, len, p);
  }
}

// K7. Replaces gunrock_tpu/ops/pallas_kernels.py _reduce_sorted_kernel
// (:949, reduce_by_dst_sorted :1320). That kernel walks the stream in
// order on one core, carrying the open run and the append offset across
// the sequential grid and compacting with a 13-stage lane router. Here
// one launch reads the stream once, a tile of kReduceTile lanes a block,
// and passes the carries from tile to tile through a tile-state array
// (a decoupled look-back), so the pass stays one ordered walk of the
// stream as the TPU kernel's is.
//
//   Tiles. A block takes the next tile from a counter in the state
//   array, so every tile before it is running or done and a wait on
//   one always ends. A warp owns kReduceRows rows of 128 lanes, a thread
//   4 consecutive lanes of each row: the keys and values are read with
//   one 16-byte load a row each, every load issued before any is used,
//   and one key past the warp tells its last tail.
//   Reduction. A thread folds its 4 lanes in order; a warp shuffle scan
//   over the threads' last runs, a carry from row to row, a scan over
//   the warps' last runs and the carry from earlier tiles complete each
//   run's value at its tail. Each step joins a run's partial from the
//   lanes before onto the partial after, in an order fixed by the
//   stream and the tile size alone.
//   Look-back, value. A tile publishes the partials of its first run
//   (head) and its last run (tail) as soon as it has reduced. Only the
//   tile that holds a run's tail needs the run's carry: it finds the
//   tile s where the run began from the keys before each tile's first
//   lane, then folds s's tail partial and the head partials of the whole
//   tiles after it, in tile order. Which predecessors have finished
//   never changes that order, so two launches agree bit for bit.
//   Look-back, count. Each tile counts its runs that pass the aux filter
//   (aux, constant in a run, is read at the tails once their values are
//   final) and publishes the count, then adds up its predecessors'
//   counts, 32 tiles a step, up to the nearest tile that has published
//   its inclusive prefix (integers, exact in any order).
//   Emit. Each kept tail writes (id, value) at its rank, so the output
//   is in ascending id order; ranks at or past out_lanes are dropped and
//   the count stays true (it signals the overflow). The last tile writes
//   the count.
//
// The tile state is one 64-bit word a field, its high half nonzero once
// written, so a field and its flag arrive together; the caller zeroes
// it before the launch. Bound: 8 bytes a lane read once, aux at the run
// tails, the output written (8 bytes a kept run). What a call takes is
// each tile's chain of steps (its tile number, its loads, the block's
// barriers, the look-backs), so the tiles are small and many are in
// flight: tiles of 2048 lanes at six blocks an SM took less time on the
// card than tiles of 1024, 4096 or 8192 lanes at the blocks their
// registers allow, and aux read at the tails after the reduction less
// than aux read with the keys.
constexpr int kReduceThreads = 256;
constexpr int kReduceRows = 2;
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kReduceWarpLanes = 128 * kReduceRows;
constexpr int kReduceTile = kReduceWarps * kReduceWarpLanes;  // 2048
// Blocks an SM the registers are held to (40 a thread): a tile's steps
// wait on one another, so more tiles in flight hide the waits.
constexpr int kReduceBlocks = 6;
constexpr unsigned kFull = 0xffffffffu;

// Tile state (kReady, kInclusive and the waits in tiles.cuh): word 0
// the tile counter; then for tile c, words 1 + 3c (head partial), 2 + 3c
// (tail partial) and 3 + 3c (count: flag 1 the tile's own, flag 2 the
// inclusive prefix).

struct ReduceArgs {
  const int32_t* sd;
  const float* vals;
  const float* aux;     // may be null: no filter
  int64_t m;
  int64_t ntiles;
  int64_t out_lanes;
  uint64_t* state;      // (1 + 3 ntiles,) zeroed
  int32_t* ids;         // (out_lanes,)
  float* ovals;         // (out_lanes,)
  int32_t* count;       // (1,)
};

template <int kOp>
__device__ __forceinline__ float identity() {
  return kOp == kSum ? 0.0f : __int_as_float(0x7f800000);  // +inf
}

// __fadd_rn keeps each sum rounded where it is written.
template <int kOp>
__device__ __forceinline__ float combine(float a, float b) {
  return kOp == kSum ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float word_float(uint64_t w) {
  return __uint_as_float((uint32_t)w);
}

// Segmented inclusive scan over a warp's lanes: a lane joins the value
// of lane - d while their keys agree (sorted keys: the lanes between
// hold the same run).
template <int kOp>
__device__ __forceinline__ float run_scan(float v, int32_t key, int lane,
                                          int width) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= width) break;
    const float o = __shfl_up_sync(kFull, v, d);
    const int32_t ok = __shfl_up_sync(kFull, key, d);
    if (lane >= d && ok == key) v = combine<kOp>(o, v);
  }
  return v;
}

template <int kOp>
__global__ void __launch_bounds__(kReduceThreads, kReduceBlocks)
reduce_tiles_kernel(ReduceArgs a) {
  __shared__ int64_t s_tile, s_excl;
  __shared__ int32_t s_wfirst[kReduceWarps], s_wlast[kReduceWarps];
  __shared__ float s_wtail[kReduceWarps];
  __shared__ int s_emits[kReduceWarps];
  __shared__ int32_t s_before;   // the key before the tile's first lane
  __shared__ float s_headp, s_tailp, s_carry;
  __shared__ int s_head_ends;    // the tile's first run ends in the tile
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_tile = (int64_t)atomicAdd(reinterpret_cast<unsigned long long*>(
                                    a.state), 1ull);
    s_head_ends = 0;
  }
  __syncthreads();
  const int64_t c = s_tile;
  const int64_t lo = c * kReduceTile;
  const int64_t hi = lo + kReduceTile < a.m ? lo + kReduceTile : a.m;
  const int64_t wbase = lo + (int64_t)warp * kReduceWarpLanes;
  const float ident = identity<kOp>();
  const bool vec = ((reinterpret_cast<uintptr_t>(a.sd) |
                     reinterpret_cast<uintptr_t>(a.vals)) & 15) == 0;

  // Loads: a row's 4 keys and values a thread, the key after the warp
  // (lane 31) and the key before the tile (thread 0).
  int32_t key[kReduceRows][4];
  float x[kReduceRows][4];
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
    const int64_t e0 = wbase + 128 * r + 4 * lane;
    if (vec && e0 + 3 < a.m) {
      const int4 k4 = __ldcs(reinterpret_cast<const int4*>(a.sd + e0));
      const float4 v4 = __ldcs(reinterpret_cast<const float4*>(a.vals + e0));
      key[r][0] = k4.x; key[r][1] = k4.y; key[r][2] = k4.z; key[r][3] = k4.w;
      x[r][0] = v4.x; x[r][1] = v4.y; x[r][2] = v4.z; x[r][3] = v4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = e0 + i < a.m;
        key[r][i] = ok ? __ldcs(a.sd + e0 + i) : INT_MIN;
        x[r][i] = ok ? __ldcs(a.vals + e0 + i) : ident;
      }
    }
  }
  const int64_t after = wbase + kReduceWarpLanes;
  const int32_t key_after = lane == 31 && after < a.m ? __ldg(a.sd + after)
                                                      : 0;
  if (t == 0) s_before = c > 0 ? __ldg(a.sd + lo - 1) : 0;

  // Tails: a lane whose next lane holds another key, or the last lane.
  unsigned tails = 0;
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
    const int64_t e0 = wbase + 128 * r + 4 * lane;
    int32_t next = __shfl_down_sync(kFull, key[r][0], 1);
    const int32_t row_next = r + 1 < kReduceRows
        ? __shfl_sync(kFull, key[r + 1 < kReduceRows ? r + 1 : r][0], 0)
        : key_after;
    if (lane == 31) next = row_next;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = e0 + i;
      const int32_t nk = i < 3 ? key[r][i + 1 < 4 ? i + 1 : i] : next;
      const bool tail = e < a.m && (e + 1 >= a.m || nk != key[r][i]);
      if (tail) tails |= 1u << (4 * r + i);
    }
  }

  // Each row: the thread's own runs, then its first run's partial from
  // the lanes before it in the row and the rows before in the warp.
  bool have_rc = false;
  int32_t rc_key = 0;
  float rc_val = ident;
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      if (key[r][i] == key[r][i - 1]) x[r][i] = combine<kOp>(x[r][i - 1],
                                                             x[r][i]);
    }
    const int32_t first = key[r][0], last = key[r][3];
    const float incl = run_scan<kOp>(x[r][3], last, lane, 32);
    const int32_t pk = __shfl_up_sync(kFull, last, 1);
    const float pe = __shfl_up_sync(kFull, incl, 1);
    const int32_t row_first = __shfl_sync(kFull, first, 0);
    const bool ex = lane > 0 && pk == first;
    const bool rc_on = have_rc && rc_key == first && row_first == first;
    if (ex || rc_on) {
      const float pre = ex && rc_on ? combine<kOp>(rc_val, pe)
                                    : (ex ? pe : rc_val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (key[r][i] == first) x[r][i] = combine<kOp>(pre, x[r][i]);
      }
    }
    rc_val = __shfl_sync(kFull, x[r][3], 31);
    rc_key = __shfl_sync(kFull, last, 31);
    have_rc = true;
  }
  const int32_t wfirst = __shfl_sync(kFull, key[0][0], 0);
  if (lane == 0) {
    s_wfirst[warp] = wfirst;
    s_wlast[warp] = rc_key;
    s_wtail[warp] = rc_val;
  }
  __syncthreads();

  // The warps' last runs, scanned in every warp alike; a run that covers
  // this warp's first lane takes the carry of the warps before.
  {
    const bool in = lane < kReduceWarps;
    const int32_t wk = in ? s_wlast[lane] : INT_MIN;
    const float ws = run_scan<kOp>(in ? s_wtail[lane] : ident, wk, lane,
                                   kReduceWarps);
    const float wc = __shfl_sync(kFull, ws, warp > 0 ? warp - 1 : 0);
    if (warp > 0 && s_wlast[warp - 1] == wfirst) {
#pragma unroll
      for (int r = 0; r < kReduceRows; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (key[r][i] == wfirst) x[r][i] = combine<kOp>(wc, x[r][i]);
        }
      }
    }
  }
  // The tile's head and tail partials.
  const int32_t tfirst = s_wfirst[0];
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = wbase + 128 * r + 4 * lane + i;
      const bool tail = (tails >> (4 * r + i)) & 1u;
      if (key[r][i] == tfirst && e < hi && (tail || e == hi - 1)) {
        s_headp = x[r][i];
        if (tail) s_head_ends = 1;
      }
      if (e == hi - 1) s_tailp = x[r][i];
    }
  }
  __syncthreads();

  uint64_t* const rec = a.state + 1 + 3 * c;
  if (t == 0) {
    store_word(rec, kReady | __float_as_uint(s_headp));
    store_word(rec + 1, kReady | __float_as_uint(s_tailp));
  }
  const bool continued = c > 0 && s_before == tfirst;
  if (warp == 0 && continued && s_head_ends) {
    // The tile s where the run began: the first tile, going back, whose
    // first lane is not preceded by the run's key.
    int64_t s = -1;
    for (int64_t base = c - 1; s < 0; base -= 32) {
      const int64_t j = base - lane;
      const bool back = j > 0 && __ldg(a.sd + j * kReduceTile - 1) == tfirst;
      const unsigned stop = __ballot_sync(kFull, !back);
      if (stop) s = base - (__ffs(stop) - 1);
    }
    // s's tail partial, then each whole tile's head partial, in order.
    float acc = ident;
    for (int64_t base = s; base < c; base += 32) {
      const int64_t j = base + lane;
      const float v = j < c ? word_float(wait_word(
                                  a.state + 1 + 3 * j + (j == s ? 1 : 0)))
                            : ident;
      const int n = c - base < 32 ? (int)(c - base) : 32;
      for (int l = 0; l < n; ++l) {
        const float u = __shfl_sync(kFull, v, l);
        acc = base + l == s ? u : combine<kOp>(acc, u);
      }
    }
    if (lane == 0) s_carry = acc;
  }
  __syncthreads();

  // Final values at the tails, the filter, and ranks within the warp:
  // rows in order, lanes in order within a row.
  const bool carry = continued && s_head_ends;
  unsigned emits = 0;
  int row_rank[kReduceRows];   // rank in the warp of the row's first emit
  int wcount = 0;
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
    const int64_t e0 = wbase + 128 * r + 4 * lane;
    int below = 0, total = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool tail = (tails >> (4 * r + i)) & 1u;
      if (carry && key[r][i] == tfirst) x[r][i] = combine<kOp>(s_carry,
                                                               x[r][i]);
      const bool emit = tail && (a.aux == nullptr ||
                                 x[r][i] < __ldg(a.aux + e0 + i));
      if (emit) emits |= 1u << (4 * r + i);
      const unsigned ball = __ballot_sync(kFull, emit);
      below += __popc(ball & ((1u << lane) - 1u));
      total += __popc(ball);
    }
    row_rank[r] = wcount + below;
    wcount += total;
  }
  if (lane == 0) s_emits[warp] = wcount;
  __syncthreads();

  int wexcl = 0, tcount = 0;
#pragma unroll
  for (int w = 0; w < kReduceWarps; ++w) {
    wexcl += w < warp ? s_emits[w] : 0;
    tcount += s_emits[w];
  }
  if (warp == 0) {
    uint64_t* const cnt = rec + 2;
    int64_t excl = 0;
    if (c == 0) {
      if (lane == 0) store_word(cnt, kInclusive | (uint32_t)tcount);
    } else {
      if (lane == 0) store_word(cnt, kReady | (uint32_t)tcount);
      excl = warp_lookback(a.state + 3, 3, c, lane);
      if (lane == 0) store_word(cnt, kInclusive | (uint32_t)(excl + tcount));
    }
    if (lane == 0) {
      s_excl = excl;
      if (c == a.ntiles - 1) *a.count = (int32_t)(excl + tcount);
    }
  }
  __syncthreads();

  const int64_t base_rank = s_excl + wexcl;
#pragma unroll
  for (int r = 0; r < kReduceRows; ++r) {
    const unsigned row = (emits >> (4 * r)) & 15u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t rk =
          base_rank + row_rank[r] + __popc(row & ((1u << i) - 1u));
      if (((row >> i) & 1u) && rk < a.out_lanes) {
        a.ids[rk] = key[r][i];
        a.ovals[rk] = x[r][i];
      }
    }
  }
}

// K8. Replaces gunrock_tpu/ops/pallas_kernels.py _scatter_sorted_kernel
// (:1151, scatter_sorted :1289), which streams the dense vector through
// VMEM tile by tile and routes each tile's updates into place with a
// 13-stage lane router, because a TPU core scatters one element at a
// time. Here one thread takes four lanes: the ids are unique, so each
// dense slot has at most one writer and a plain read-modify-write is
// exact, in any order. The count is read from device memory when given
// as a pointer, so a caller that got it from K7 reads nothing back; the
// buffer may be far longer than the count (phase 14 of chip_smoke.py:
// 135,241 winners in a 2^20-lane buffer), so the grid is a few blocks an
// SM, each reading the count once, striding over the live lanes only.
// Ids and values are read 16 bytes a thread where the base is aligned,
// the last count % 4 lanes one at a time.
// Bound: 8 bytes a lane streamed plus one random 4-byte read and write.
// At phase 14's size the kernel takes 0.002-0.005 ms on the device and a
// call about 0.025-0.04 ms: the ctypes call and the launch alone take
// about 0.01 (tools/profile_pull.py), the wrapper's checks the rest.
template <typename T>
__device__ __forceinline__ T apply_op(int op, T old, T v);

template <>
__device__ __forceinline__ float apply_op<float>(int op, float old, float v) {
  switch (op) {
    case kMin: return fminf(old, v);
    case kMax: return fmaxf(old, v);
    case kSum: return __fadd_rn(old, v);
    default: return v;
  }
}

template <>
__device__ __forceinline__ int32_t apply_op<int32_t>(int op, int32_t old,
                                                     int32_t v) {
  switch (op) {
    case kMin: return old < v ? old : v;
    case kMax: return old > v ? old : v;
    case kSum: return old + v;
    default: return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t bits) {
  T v;
  memcpy(&v, &bits, sizeof(v));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_sorted_kernel(T* __restrict__ dense, int64_t n,
                      const int32_t* __restrict__ ids,
                      const uint32_t* __restrict__ vals, int64_t m,
                      const int32_t* __restrict__ count_ptr, int64_t count,
                      int op) {
  __shared__ int64_t live;
  if (threadIdx.x == 0) {
    const int64_t c = count_ptr != nullptr ? (int64_t)*count_ptr : count;
    live = c < m ? c : m;
  }
  __syncthreads();
  const int64_t limit = live;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(vals))
       & 15) == 0;
  const int64_t quads = aligned && limit > 0 ? limit / 4 : 0;
  for (int64_t q = first; q < quads; q += stride) {
    const int4 id4 = __ldcs(reinterpret_cast<const int4*>(ids) + q);
    const uint4 v4 = __ldcs(reinterpret_cast<const uint4*>(vals) + q);
    const int32_t id[4] = {id4.x, id4.y, id4.z, id4.w};
    const uint32_t bits[4] = {v4.x, v4.y, v4.z, v4.w};
    // The ids are unique, so the four slots are distinct: read all four
    // before writing any, one round trip instead of four.
    T old[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (id[j] >= 0 && id[j] < n) old[j] = dense[id[j]];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (id[j] >= 0 && id[j] < n) {
        dense[id[j]] = apply_op<T>(op, old[j], from_bits<T>(bits[j]));
      }
    }
  }
  for (int64_t i = 4 * quads + first; i < limit; i += stride) {
    const int32_t id = __ldcs(ids + i);
    if (id >= 0 && id < n) {
      dense[id] = apply_op<T>(op, dense[id], from_bits<T>(__ldcs(vals + i)));
    }
  }
}

}  // namespace

extern "C" {

// K5. b and out_b may be null (one array). pos64: positions are int64
// (else int32).
int gr_sample_sorted(const void* a, const void* b, int64_t len,
                     const void* pos, int pos64, int64_t n, void* out_a,
                     void* out_b, void* stream) {
  if ((b == nullptr) != (out_b == nullptr)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool aligned = ((reinterpret_cast<uintptr_t>(pos) |
                           reinterpret_cast<uintptr_t>(out_a) |
                           reinterpret_cast<uintptr_t>(out_b)) & 15) == 0;
    // Threads for the quads (kSampleQuads a trip) or for each position;
    // at most eight blocks an SM, striding.
    const int64_t work =
        aligned ? (n / 4 + kSampleQuads - 1) / kSampleQuads + n % 4 : n;
    const int64_t want = (work + kThreads - 1) / kThreads;
    const int64_t cap = 8 * (int64_t)sm_count();
    const unsigned int grid = (unsigned int)(want < cap ? want : cap);
    if (pos64) {
      sample_sorted_kernel<int64_t><<<grid, kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, len, (const int64_t*)pos,
          n, (uint32_t*)out_a, (uint32_t*)out_b);
    } else {
      sample_sorted_kernel<int32_t><<<grid, kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, len, (const int32_t*)pos,
          n, (uint32_t*)out_a, (uint32_t*)out_b);
    }
  }
  return (int)cudaGetLastError();
}

// K7. op: 0 min, 1 sum. aux may be null. tile must be kReduceTile.
// state: (1 + 3 ceil(m / tile),) 64-bit words, zeroed here before the
// launch. count: (1,) int32.
int gr_reduce_by_dst_sorted(const void* sd, const void* vals,
                            const void* aux, int64_t m, int op, int tile,
                            int64_t out_lanes, void* state, void* ids,
                            void* ovals, void* count, void* stream) {
  if ((op != kMin && op != kSum) || tile != kReduceTile || m < 0 ||
      out_lanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) {
    cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    return (int)cudaGetLastError();
  }
  ReduceArgs a;
  a.sd = (const int32_t*)sd;
  a.vals = (const float*)vals;
  a.aux = (const float*)aux;
  a.m = m;
  a.ntiles = (m + kReduceTile - 1) / kReduceTile;
  a.out_lanes = out_lanes;
  a.state = (uint64_t*)state;
  a.ids = (int32_t*)ids;
  a.ovals = (float*)ovals;
  a.count = (int32_t*)count;
  cudaMemsetAsync(state, 0, (1 + 3 * a.ntiles) * sizeof(uint64_t), s);
  const unsigned int grid = (unsigned int)a.ntiles;
  if (op == kMin) {
    reduce_tiles_kernel<kMin><<<grid, kReduceThreads, 0, s>>>(a);
  } else {
    reduce_tiles_kernel<kSum><<<grid, kReduceThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// K8. is_float: dense and vals are float32 (else int32). op: 0 min,
// 1 add, 2 max, 3 set. count_ptr (int32, device) overrides count when
// not null.
int gr_scatter_sorted(void* dense, int64_t n, const void* ids,
                      const void* vals, int64_t m, const void* count_ptr,
                      int64_t count, int is_float, int op, void* stream) {
  if (op < kMin || op > kSet) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    // Four lanes a thread, at most four blocks an SM.
    const int64_t cap = 4 * (int64_t)sm_count();
    const int64_t want = ((m + 3) / 4 + kThreads - 1) / kThreads;
    const unsigned int grid = (unsigned int)(want < cap ? want : cap);
    if (is_float) {
      scatter_sorted_kernel<float><<<grid, kThreads, 0, s>>>(
          (float*)dense, n, (const int32_t*)ids, (const uint32_t*)vals, m,
          (const int32_t*)count_ptr, count, op);
    } else {
      scatter_sorted_kernel<int32_t><<<grid, kThreads, 0, s>>>(
          (int32_t*)dense, n, (const int32_t*)ids, (const uint32_t*)vals, m,
          (const int32_t*)count_ptr, count, op);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
