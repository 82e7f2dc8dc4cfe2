// K3: the apply step of a small-segment elimination pass, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package applies a pass's merges with
// XLA segment sums (pyshepseg_tpu/ops/elim_small.py). The port applied
// them with two capacity-sized index_add_ calls, in which every segment
// that does not move adds 0 into row 0: an H100 profile of a 4096^2 tile
// (about 1.1 M segment ids, some 216 passes) showed those two calls at 70 %
// of the device's time, about a million int64 atomics a pass serialised
// on one L2 address.
//
// What it computes (ops/elim_small.py, merge_apply_reference), for every
// segment id i < capacity:
//
//   move = size[i] == target && i >= min_id && best_nbr[i] != no_nbr
//          && d_best[i] <= max_d
//   merge_map[i] = move ? best_nbr[i] : i
//   if move: size[t] += size[i] and sums[b][t] += sums[b][i] for every
//            band b, t = best_nbr[i]; then size[i] = sums[b][i] = 0
//   *movers = the number of ids that move
//
// In place, and race-free: within a pass candidates (size == target) and
// targets (size > target, in the snapshot the pass decided on) are
// disjoint. A mover's row is read and zeroed by its own thread only; a
// target's row only receives atomics, and its size stays above target
// before and after each add, so its own thread's test reads false either
// way. Integer adds (int64 as two's-complement unsigned long long) are
// exact in any order: the result is the plain version's bit for bit.
//
// Design. One thread per id, grid-stride over a grid that fills the SMs
// once. Every thread reads its size and writes its merge_map entry; only
// a candidate reads best_nbr and d_best, and only a mover issues atomics
// (nBands + 1 of them, as reductions whose result is unused). The movers
// are counted per warp (__reduce_add_sync), per block in shared memory,
// and added with one atomic a block into an int64 that the host zeroes on
// the stream first.
//
// Bound: device memory traffic. Per id size read (8 B) and merge_map
// written (8 B); per candidate best_nbr (8 B) and d_best (4 B) read; per
// mover (nBands + 1) x 8 B three times: the mover's row read, the
// target's row updated, the mover's row zeroed.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
    merge_apply_kernel(long long* __restrict__ size,
                       long long* __restrict__ sums, int nbands,
                       const long long* __restrict__ best_nbr,
                       const float* __restrict__ d_best,
                       long long* __restrict__ merge_map,
                       unsigned long long* __restrict__ movers,
                       long long capacity, long long target, long long min_id,
                       long long no_nbr, float max_d) {
  __shared__ unsigned int warp_movers[kThreads / 32];
  unsigned int mine = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < capacity; i += stride) {
    const long long s = size[i];
    long long to = i;
    bool move = false;
    if (s == target && i >= min_id) {
      const long long nb = best_nbr[i];
      if (nb != no_nbr && d_best[i] <= max_d) {
        to = nb;
        move = true;
      }
    }
    merge_map[i] = to;
    if (move) {
      atomicAdd(reinterpret_cast<unsigned long long*>(size + to),
                static_cast<unsigned long long>(s));
      size[i] = 0;
      for (int b = 0; b < nbands; ++b) {
        long long* row = sums + (long long)b * capacity;
        atomicAdd(reinterpret_cast<unsigned long long*>(row + to),
                  static_cast<unsigned long long>(row[i]));
        row[i] = 0;
      }
      ++mine;
    }
  }
  // every thread reaches the reductions: none returns early
  const unsigned int w = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) warp_movers[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned int v = threadIdx.x < kThreads / 32 ? warp_movers[threadIdx.x] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (threadIdx.x == 0 && v) atomicAdd(movers, (unsigned long long)v);
  }
}

// The most blocks a device holds at once, queried on its first launch.
std::mutex g_mu;
int g_blocks[kMaxDevices];

// Under a lock: the tiled driver's worker threads launch concurrently. The
// caller has made `dev` the current device.
cudaError_t resident_blocks(int dev, int* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, merge_apply_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    g_blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = g_blocks[dev];
  return cudaSuccess;
}

}  // namespace

// size: (capacity,) int64; sums: (nbands, capacity) int64, row-major;
// best_nbr: (capacity,) int64; d_best: (capacity,) float32; merge_map:
// (capacity,) int64 out; movers: one int64 out. All contiguous on
// `device`, which the caller has made current; size and sums are updated
// in place. Zeroes `movers` and launches on `stream`. Returns
// cudaGetLastError() after the launch, or an error code for arguments the
// kernel does not take.
extern "C" int merge_apply_launch(void* size, void* sums, int nbands,
                                  const void* best_nbr, const void* d_best,
                                  void* merge_map, void* movers,
                                  long long capacity, long long target,
                                  long long min_id, long long no_nbr,
                                  float max_d, int device, void* stream) {
  if (capacity < 0 || nbands < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(movers, 0, sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  if (capacity == 0) return (int)cudaGetLastError();
  int most = 0;
  e = resident_blocks(device, &most);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (capacity + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  merge_apply_kernel<<<(int)blocks, kThreads, 0, s>>>(
      static_cast<long long*>(size), static_cast<long long*>(sums), nbands,
      static_cast<const long long*>(best_nbr),
      static_cast<const float*>(d_best), static_cast<long long*>(merge_map),
      static_cast<unsigned long long*>(movers), capacity, target, min_id,
      no_nbr, max_d);
  return (int)cudaGetLastError();
}
