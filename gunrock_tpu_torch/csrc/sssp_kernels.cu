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
// cudaErrorInvalidValue for arguments it does not take).

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int64_t kMaxBlocks = 1 << 16;

enum Op : int { kMin = 0, kSum = 1, kMax = 2, kSet = 3 };

unsigned int blocks_for(int64_t threads) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// K5. Replaces gunrock_tpu/ops/pallas_kernels.py _sample_kernel (:594,
// sample_sorted :665) and _sample2_kernel (:686, sample_sorted2 :783).
// Those walk the sorted positions chunk by chunk through VMEM windows,
// because a TPU core cannot gather from HBM. Here each thread reads its
// element directly, one thread per position over a grid-stride loop,
// any length. Sorted positions make neighbouring threads read
// neighbouring addresses, so the reads coalesce; any order is correct.
// Both dtypes are 32 bits wide and are moved as raw bits. Bound: the
// position read and the output writes stream (8-16 bytes a position);
// the gathered reads, sorted, touch each 32-byte sector about once.
template <typename I>
__global__ void sample_sorted_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     int64_t len, const I* __restrict__ pos,
                                     int64_t n, uint32_t* __restrict__ out_a,
                                     uint32_t* __restrict__ out_b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t p = (int64_t)pos[i];
    const bool ok = p >= 0 && p < len;
    out_a[i] = ok ? __ldg(a + p) : 0u;
    if (b != nullptr) out_b[i] = ok ? __ldg(b + p) : 0u;
  }
}

// K7. Replaces gunrock_tpu/ops/pallas_kernels.py _reduce_sorted_kernel
// (:949, reduce_by_dst_sorted :1320). That kernel walks the stream in
// order on one core, carrying the open run and the append offset across
// the sequential grid and compacting with a 13-stage lane router. Here
// blocks run in any order, so the work is cut by elements, as K3 cuts
// CSC edges: a warp owns `chunk` consecutive lanes (a multiple of 32),
// and a run that spans chunks is joined from per-chunk partials.
//
//   pass 1 (warp per chunk): segmented inclusive scan, 32 lanes a step,
//     with a warp-uniform carry. At each run tail inside the chunk, part
//     holds the run's partial over the chunk; headp/tailp hold the
//     partials of the chunk's first and last runs.
//   pass 2 (warp per chunk): a tail whose run began in an earlier chunk
//     adds tailp of the chunk where it began and headp of each chunk it
//     covers whole, in chunk order (one thread walks them, as K3's pass 2
//     walks a hub row), then the partial in its own chunk. The run value
//     replaces part at the tail; the tails that pass the aux filter are
//     counted per chunk.
//   pass 3 (one block): exclusive scan of the per-chunk counts into
//     offsets; the total is the count, written to device memory.
//   pass 4 (warp per chunk): each emitted tail writes (id, value) at its
//     chunk's offset plus its rank among the chunk's emitted tails, so the
//     output is in ascending id order. Ranks at or past out_lanes are
//     dropped and the count stays true (it signals the overflow).
//
// Every sum is taken in an order that depends only on the stream and
// the chunk size, so two launches agree bit for bit; min is exact.
// Bound: the stream is read three times (keys, values, aux: 12 bytes a
// lane each time) plus the part writes; about 40 bytes a lane.
struct ReduceArgs {
  const int32_t* sd;
  const float* vals;
  const float* aux;     // may be null: no filter
  int64_t m;
  int op;               // kMin or kSum
  int chunk;
  int64_t out_lanes;
  float* part;          // (m,) scratch
  float* headp;         // (nchunks,) scratch
  float* tailp;         // (nchunks,) scratch
  int32_t* cnt;         // (nchunks,) scratch
  int32_t* offs;        // (nchunks,) scratch
  int32_t* ids;         // (out_lanes,)
  float* ovals;         // (out_lanes,)
  int32_t* count;       // (1,)
};

__device__ __forceinline__ float identity(int op) {
  return op == kSum ? 0.0f : __int_as_float(0x7f800000);  // +inf
}

// __fadd_rn keeps each sum rounded where the plain version rounds it.
__device__ __forceinline__ float combine(int op, float a, float b) {
  return op == kSum ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ bool is_tail(const ReduceArgs& a, int64_t e,
                                        int32_t key) {
  return e + 1 >= a.m || __ldg(a.sd + e + 1) != key;
}

__device__ __forceinline__ int64_t num_chunks(const ReduceArgs& a) {
  return (a.m + a.chunk - 1) / a.chunk;
}

__global__ void reduce_chunks_kernel(ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const float ident = identity(a.op);
  for (int64_t c = warp; c < num_chunks(a); c += nwarps) {
    const int64_t lo = c * a.chunk;
    const int64_t hi = lo + a.chunk < a.m ? lo + a.chunk : a.m;
    const int32_t first_key = __ldg(a.sd + lo);
    bool have_carry = false;  // warp-uniform
    int32_t carry_key = 0;
    float carry = ident;
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t e = base + lane;
      const bool valid = e < hi;
      // Lanes past the end sit above every valid lane, and the scan
      // only reads lower lanes, so their key and value touch nothing.
      const int32_t key = valid ? __ldg(a.sd + e) : INT_MIN;
      float x = valid ? __ldg(a.vals + e) : ident;
      // Keys are sorted, so equal keys at lanes l - d and l mean one run
      // covers l - d..l: after the loop x is the run's prefix in the step.
      for (int d = 1; d < 32; d <<= 1) {
        const float ox = __shfl_up_sync(0xffffffffu, x, d);
        const int32_t okey = __shfl_up_sync(0xffffffffu, key, d);
        if (lane >= d && okey == key) x = combine(a.op, ox, x);
      }
      if (have_carry && key == carry_key) x = combine(a.op, carry, x);
      if (valid) {
        const bool tail = is_tail(a, e, key);
        if (tail) a.part[e] = x;
        if (key == first_key && (tail || e == hi - 1)) a.headp[c] = x;
        if (e == hi - 1) a.tailp[c] = x;
      }
      carry = __shfl_sync(0xffffffffu, x, 31);
      carry_key = __shfl_sync(0xffffffffu, key, 31);
      have_carry = true;
    }
  }
}

__device__ __forceinline__ bool passes(const ReduceArgs& a, int64_t e,
                                       float v) {
  return a.aux == nullptr || v < __ldg(a.aux + e);
}

__global__ void reduce_join_kernel(ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t c = warp; c < num_chunks(a); c += nwarps) {
    const int64_t lo = c * a.chunk;
    const int64_t hi = lo + a.chunk < a.m ? lo + a.chunk : a.m;
    // The chunk's first run began earlier iff the lane before lo has
    // the same key.
    const int32_t first_key = __ldg(a.sd + lo);
    const bool continued = c > 0 && __ldg(a.sd + lo - 1) == first_key;
    int32_t emitted = 0;
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t e = base + lane;
      bool emit = false;
      if (e < hi) {
        const int32_t key = __ldg(a.sd + e);
        if (is_tail(a, e, key)) {
          float v = a.part[e];
          if (continued && key == first_key) {
            // The chunk where the run began: step back while the lane
            // before a chunk's first lane holds the key too (a run that
            // begins exactly at a chunk's first lane began there).
            int64_t cs = c - 1;
            while (cs > 0 && __ldg(a.sd + cs * a.chunk - 1) == key) --cs;
            float acc = a.tailp[cs];
            for (int64_t cc = cs + 1; cc < c; ++cc) {
              acc = combine(a.op, acc, a.headp[cc]);
            }
            v = combine(a.op, acc, v);
            a.part[e] = v;
          }
          emit = passes(a, e, v);
        }
      }
      emitted += __popc(__ballot_sync(0xffffffffu, emit));
    }
    if (lane == 0) a.cnt[c] = emitted;
  }
}

// One block: offs = exclusive scan of cnt; *count = the total.
__global__ void reduce_scan_kernel(ReduceArgs a) {
  __shared__ int64_t sums[kScanThreads];
  const int t = threadIdx.x;
  const int64_t n = num_chunks(a);
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = t * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += a.cnt[i];
  sums[t] = s;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int64_t v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int64_t run = t > 0 ? sums[t - 1] : 0;
  for (int64_t i = lo; i < hi; ++i) {
    a.offs[i] = (int32_t)run;
    run += a.cnt[i];
  }
  if (t == kScanThreads - 1) *a.count = (int32_t)sums[t];
}

__global__ void reduce_emit_kernel(ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t c = warp; c < num_chunks(a); c += nwarps) {
    const int64_t lo = c * a.chunk;
    const int64_t hi = lo + a.chunk < a.m ? lo + a.chunk : a.m;
    int64_t rank0 = a.offs[c];
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t e = base + lane;
      bool emit = false;
      int32_t key = 0;
      float v = 0.0f;
      if (e < hi) {
        key = __ldg(a.sd + e);
        if (is_tail(a, e, key)) {
          v = a.part[e];
          emit = passes(a, e, v);
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, emit);
      if (emit) {
        const int64_t rank = rank0 + __popc(mask & ((1u << lane) - 1u));
        if (rank < a.out_lanes) {
          a.ids[rank] = key;
          a.ovals[rank] = v;
        }
      }
      rank0 += __popc(mask);
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

// Multiprocessors of the current device, read once a device.
int sm_count() {
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
    if (pos64) {
      sample_sorted_kernel<int64_t><<<blocks_for(n), kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, len, (const int64_t*)pos,
          n, (uint32_t*)out_a, (uint32_t*)out_b);
    } else {
      sample_sorted_kernel<int32_t><<<blocks_for(n), kThreads, 0, s>>>(
          (const uint32_t*)a, (const uint32_t*)b, len, (const int32_t*)pos,
          n, (uint32_t*)out_a, (uint32_t*)out_b);
    }
  }
  return (int)cudaGetLastError();
}

// K7. op: 0 min, 1 sum. aux may be null. Scratch: part (m,) float32;
// headp, tailp (nchunks,) float32; cnt, offs (nchunks,) int32, with
// nchunks = ceil(m / chunk). count: (1,) int32.
int gr_reduce_by_dst_sorted(const void* sd, const void* vals,
                            const void* aux, int64_t m, int op, int chunk,
                            int64_t out_lanes, void* part, void* headp,
                            void* tailp, void* cnt, void* offs, void* ids,
                            void* ovals, void* count, void* stream) {
  if ((op != kMin && op != kSum) || chunk <= 0 || chunk % 32 != 0 ||
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
  a.op = op;
  a.chunk = chunk;
  a.out_lanes = out_lanes;
  a.part = (float*)part;
  a.headp = (float*)headp;
  a.tailp = (float*)tailp;
  a.cnt = (int32_t*)cnt;
  a.offs = (int32_t*)offs;
  a.ids = (int32_t*)ids;
  a.ovals = (float*)ovals;
  a.count = (int32_t*)count;
  const unsigned int grid = blocks_for(((m + chunk - 1) / chunk) * 32);
  reduce_chunks_kernel<<<grid, kThreads, 0, s>>>(a);
  reduce_join_kernel<<<grid, kThreads, 0, s>>>(a);
  reduce_scan_kernel<<<1, kScanThreads, 0, s>>>(a);
  reduce_emit_kernel<<<grid, kThreads, 0, s>>>(a);
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
