// K4: float32 segment sums in serial order, for Hopper (sm_90a), and the
// selection step of a graph pass with float32 sums.
//
// Replaces no Pallas kernel: the JAX package sums float imagery with XLA
// segment sums. The port summed floats on the card with a stable sort and
// a Hillis-Steele scan (ceil(log2 n) rounds over every element), whose
// order no plain sum follows, so a float tile on the card could take other
// merge decisions than on the CPU wherever one sat on a one-ulp tie.
//
// What ordered_sum computes (ops/segreduce.py, ordered_sum): the bits of
// the CPU's torch.zeros(...).index_add_(dim, index, source) for float32.
// Every bin starts at +0.0 and its elements are added one at a time in
// increasing position order; bins are independent. Its input is one int64
// key an element, (bin << 32) | position, sorted ascending on the host
// side (a library sort; unique keys, so stability does not matter): each
// bin's elements are then a run of consecutive keys in position order.
// For every run whose bin lies in [0, nbins), for each column c:
//
//   total = +0.0; for each key of the run: total += src[pos, c]
//   out[bin, c] += total          (out zeroed first for a plain sum)
//   if zero_src: src[pos, c] = 0  (each element after it was read)
//
// A run's total is never -0.0 (round to nearest gives +0.0 on exact
// cancellation), so adding it to a zeroed bin stores it as it is. Keys with
// a bin outside [0, nbins) are skipped: the selection step pads its key
// buffer with INT64_MAX.
//
// Design. One warp per 32 consecutive keys. A lane whose key starts a run
// (its bin differs from the key before) is found by a ballot; for each
// such start, in lane order, the whole warp walks the run: the lanes load
// 32 consecutive keys and their rows (coalesced keys, gathered rows, many
// loads in flight across the warp) and the serial adds go through a
// broadcast shuffle, lane by lane, every lane holding the same running
// total (so the order is the keys' order). A run longer than one chunk
// continues in steps of kUnroll chunks whose loads are all issued before
// the adds, so a long run (a k-means cluster of 10^5 points) is not paced
// by one load latency a chunk. kCols columns are carried in registers;
// more columns walk the run again. Each run is walked by exactly one warp
// and each bin is one run, so no atomics are needed and no two warps write
// one address. In place use (src == out, the graph pass) is race-free when
// no position of a run is the bin of another, as in a pass: movers are
// never targets.
//
// merge_movers (ops/elim_small.py, merge_apply_movers): for every id i of
// a pass with float32 sums, the predicate and the integer parts of K3
//
//   move = size[i] == target && i >= min_id && best_nbr[i] != no_nbr
//          && d_best[i] <= max_d
//   merge_map[i] = move ? best_nbr[i] : i
//   if move: size[t] += size[i] (int64 atomic, exact), size[i] = 0, and
//            the key (t << 32) | i goes to the next free slot of `keys`
//
// with the slots taken by one atomic a warp. `keys` has one slot for each
// candidate (size == target), a count the host holds already, so it never
// overflows; its free slots keep the INT64_MAX the host filled in. The
// slot counter ends as the number of movers. Sorted, the keys give each
// target's movers in ascending id, which ordered_sum then adds from +0.0
// onto the target's row, zeroing the movers' rows.
//
// Bound: device memory traffic. ordered_sum: each key read (8 B), each
// element's row read (4 B a column; gathered, so at least a 32 B sector an
// element and column when rows are scattered), each run's bin read and
// written (4 B a column each). merge_movers: as K3's integer part, 16 B an
// id, 12 B a candidate, 8 B a mover's key.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long bin_of(long long key) { return key >> 32; }
__device__ __forceinline__ long long pos_of(long long key) {
  return key & 0xffffffffLL;
}

// One chunk of 32 keys from `first`: each lane's columns of its element
// when its key is in bin `bin` (a prefix of the lanes, since the keys are
// sorted), and how many lanes that is.
__device__ __forceinline__ int load_chunk(
    const long long* __restrict__ keys, long long n, long long first,
    long long bin, float* src, long long rs, long long cs, int c0, int cn,
    int zero_src, int lane, float (&v)[kCols]) {
  const long long j = first + lane;
  bool in = false;
  long long pos = 0;
  if (j < n) {
    const long long k = keys[j];
    in = bin_of(k) == bin;
    pos = pos_of(k);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    v[c] = 0.0f;
    if (in && c < cn) {
      float* p = src + pos * rs + (long long)(c0 + c) * cs;
      v[c] = *p;
      if (zero_src) *p = 0.0f;
    }
  }
  return __popc(__ballot_sync(kFull, in));
}

// The serial adds of one chunk's first `cnt` lanes, in lane order.
__device__ __forceinline__ void add_chunk(float (&acc)[kCols],
                                          const float (&v)[kCols], int cnt) {
  for (int i = 0; i < cnt; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] += __shfl_sync(kFull, v[c], i);
  }
}

__global__ void __launch_bounds__(kThreads)
    ordered_sum_kernel(const long long* __restrict__ keys, long long n,
                       float* src, long long rs, long long cs, int ncols,
                       float* out, long long ors, long long ocs,
                       long long nbins, int zero_src) {
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) - lane;
  const long long j = first + lane;
  long long bin = -1;
  bool start = false;
  if (j < n) {
    bin = bin_of(keys[j]);
    start = j == 0 || bin_of(keys[j - 1]) != bin;
  }
  unsigned starts = __ballot_sync(kFull, start);
  while (starts) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1;
    const long long b = __shfl_sync(kFull, bin, s);
    if (b < 0 || b >= nbins) continue;
    for (int c0 = 0; c0 < ncols; c0 += kCols) {
      const int cn = ncols - c0 < kCols ? ncols - c0 : kCols;
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
      float v[kUnroll][kCols];
      long long at = first + s;
      int cnt = load_chunk(keys, n, at, b, src, rs, cs, c0, cn, zero_src,
                           lane, v[0]);
      add_chunk(acc, v[0], cnt);
      // a run that filled the chunk may go on: kUnroll chunks a step,
      // every load of the step issued before its adds
      while (cnt == 32) {
        at += 32;
        int cnts[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          cnts[u] = load_chunk(keys, n, at + 32LL * u, b, src, rs, cs, c0, cn,
                               zero_src, lane, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_chunk(acc, v[u], cnts[u]);
        // the chunks after the run's last one load nothing and count 0
        cnt = cnts[kUnroll - 1];
        at += 32LL * (kUnroll - 1);
      }
      if (lane == 0) {
        for (int c = 0; c < cn; ++c) {
          float* o = out + b * ors + (long long)(c0 + c) * ocs;
          *o = *o + acc[c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_movers_kernel(long long* __restrict__ size,
                        const long long* __restrict__ best_nbr,
                        const float* __restrict__ d_best,
                        long long* __restrict__ merge_map,
                        long long* __restrict__ keys, long long slots,
                        unsigned long long* __restrict__ movers,
                        long long capacity, long long target,
                        long long min_id, long long no_nbr, float max_d) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // warp-uniform trip count: every lane takes part in each ballot
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x -
                        lane;
       base < capacity; base += stride) {
    const long long i = base + lane;
    long long to = i;
    long long s = 0;
    bool move = false;
    if (i < capacity) {
      s = size[i];
      if (s == target && i >= min_id) {
        const long long nb = best_nbr[i];
        if (nb != no_nbr && d_best[i] <= max_d) {
          to = nb;
          move = true;
        }
      }
      merge_map[i] = to;
    }
    const unsigned m = __ballot_sync(kFull, move);
    if (!m) continue;
    unsigned long long slot = 0;
    if (lane == __ffs(m) - 1) slot = atomicAdd(movers, (unsigned long long)__popc(m));
    slot = __shfl_sync(kFull, slot, __ffs(m) - 1) +
           __popc(m & ((1u << lane) - 1u));
    if (move) {
      atomicAdd(reinterpret_cast<unsigned long long*>(size + to),
                static_cast<unsigned long long>(s));
      size[i] = 0;
      if ((long long)slot < slots) keys[slot] = (to << 32) | i;
    }
  }
}

}  // namespace

// keys: (n,) int64, sorted ascending, each (bin << 32) | position; src:
// float32 element `pos`, column c at src[pos * rs + c * cs]; out: float32
// bin b, column c at out[b * ors + c * ocs]. src and out may be one
// buffer (see the header). On the device the caller has made current;
// launches on `stream`. Returns cudaGetLastError() after the launch, or
// an error code for arguments the kernel does not take.
extern "C" int ordered_sum_launch(const void* keys, long long n, void* src,
                                  long long rs, long long cs, int ncols,
                                  void* out, long long ors, long long ocs,
                                  long long nbins, int zero_src,
                                  void* stream) {
  if (n < 0 || ncols < 0 || nbins < 0) return cudaErrorInvalidValue;
  if (n == 0 || ncols == 0) return (int)cudaGetLastError();
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ordered_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<float*>(src), rs,
      cs, ncols, static_cast<float*>(out), ors, ocs, nbins, zero_src);
  return (int)cudaGetLastError();
}

// size, best_nbr, merge_map: (capacity,) int64; d_best: (capacity,)
// float32; keys: (slots,) int64, filled with INT64_MAX by the caller;
// movers: one int64 out. All contiguous on `device`, which the caller has
// made current; size is updated in place. Zeroes `movers` and launches on
// `stream`. Returns cudaGetLastError() after the launch, or an error code
// for arguments the kernel does not take.
extern "C" int merge_movers_launch(void* size, const void* best_nbr,
                                   const void* d_best, void* merge_map,
                                   void* keys, long long slots, void* movers,
                                   long long capacity, long long target,
                                   long long min_id, long long no_nbr,
                                   float max_d, int device, void* stream) {
  if (capacity < 0 || slots < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(movers, 0, sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (capacity == 0) return (int)cudaGetLastError();
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  // a grid that fills the SMs (8 blocks of 256 threads each), striding
  long long blocks = (capacity + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  merge_movers_kernel<<<(int)blocks, kThreads, 0, s>>>(
      static_cast<long long*>(size), static_cast<const long long*>(best_nbr),
      static_cast<const float*>(d_best), static_cast<long long*>(merge_map),
      static_cast<long long*>(keys), slots,
      static_cast<unsigned long long*>(movers), capacity, target, min_id,
      no_nbr, max_d);
  return (int)cudaGetLastError();
}
