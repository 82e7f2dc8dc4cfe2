// K2: gather from a lookup table for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _lut_kernel in pyshepseg_tpu/ops/lut.py
// (launched by lut_gather / lut_gather_flat there): out[i] = table[idx[i]],
// exact, for int32 or int64 indices and an int32 or int64 table of up to
// 2^31 - 1 entries. The output has the table's type; no lane is narrowed.
//
// Design. The TPU kernel loops over 128-lane table rows because Mosaic has
// no general in-VMEM gather, and so it is limited to small tables. The card
// gathers natively; what matters is where the table is read from. Two
// routes, chosen on the host (ops/lut.py, lut_route) by the reuse n / c:
//
// - direct: no staging. Each thread loads 16 bytes of indices at a time
//   and reads every entry through the read-only path (__ldg) from a table
//   that stays resident in the 50 MB L2; the index and output streams are
//   marked evict-first so that they do not push the table out. The grid
//   covers the SMs (sized by occupancy, or by n when that is smaller) and
//   strides over the index vectors. Serves low reuse (the graph passes,
//   n / c ~ 3; the remap composition, n / c = 1) and every table too large
//   for shared memory.
// - staged: a persistent grid of as many 1024-thread blocks as the SMs
//   hold at once (1 or 2 per SM, by the table's size). One thread of each block
//   stages the table into dynamic shared memory with one TMA bulk copy
//   completed on an mbarrier; every thread issues its first index load
//   before it waits, so the copy overlaps the index stream. Lookups then
//   hit shared memory. Serves high reuse (the final relabel) when the
//   table fits the 227 KB a block may use.
//
// Both routes take a scalar head (until the index pointer is 16-byte
// aligned) and a scalar tail, and store vectors when the output is aligned
// at the head, scalars otherwise. The staged route places the table in
// shared memory at its global address modulo 16, so the bulk copy's
// 16-byte-aligned body has an aligned destination; the few entries before
// and after it are copied with plain loads.
//
// Bound: device memory traffic of the index and output streams; on top of
// it the direct route reads one 32-byte L2 sector per index, the staged
// route the table once per block.

#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kDirectThreads = 128;
constexpr int kStagedThreads = 1024;
constexpr int kMaxDevices = 64;

// 16 bytes of indices: 4 int32 or 2 int64
template <typename I>
struct IdxVec {
  static constexpr int K = 16 / sizeof(I);
  I k[K];
};

template <typename I>
__device__ __forceinline__ IdxVec<I> load_idx(const I* p, long long v) {
  IdxVec<I> r;
  if constexpr (sizeof(I) == 4) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p) + v);
    r.k[0] = q.x;
    r.k[1] = q.y;
    r.k[2] = q.z;
    r.k[3] = q.w;
  } else {
    const longlong2 q = __ldcs(reinterpret_cast<const longlong2*>(p) + v);
    r.k[0] = q.x;
    r.k[1] = q.y;
  }
  return r;
}

// Store the K results of index vector v: 8, 16 or 32 bytes as vectors when
// `vec`, else as scalars.
template <typename V, int K>
__device__ __forceinline__ void store_out(V* p, long long v, const V (&r)[K],
                                          bool vec) {
  if (!vec) {
#pragma unroll
    for (int j = 0; j < K; ++j) __stcs(p + v * K + j, r[j]);
  } else if constexpr (sizeof(V) == 4 && K == 4) {
    __stcs(reinterpret_cast<int4*>(p) + v, make_int4(r[0], r[1], r[2], r[3]));
  } else if constexpr (sizeof(V) == 4) {
    __stcs(reinterpret_cast<int2*>(p) + v, make_int2(r[0], r[1]));
  } else if constexpr (K == 2) {
    __stcs(reinterpret_cast<longlong2*>(p) + v, make_longlong2(r[0], r[1]));
  } else {
    longlong2* q = reinterpret_cast<longlong2*>(p) + 2 * v;
    __stcs(q, make_longlong2(r[0], r[1]));
    __stcs(q + 1, make_longlong2(r[2], r[3]));
  }
}

// out[i] = look(idx[i]) for i < n over the whole grid. Index vectors start
// at element `head`, where idx is 16-byte aligned; each thread keeps the
// next vector's load in flight while it looks up the current one. `wait`
// runs after a thread's first index loads and before its first lookup.
template <typename I, typename V, typename Look, typename Wait>
__device__ __forceinline__ void gather(const I* __restrict__ idx,
                                       V* __restrict__ out, long long n,
                                       int head, bool out_vec, Look look,
                                       Wait wait) {
  constexpr int K = IdxVec<I>::K;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nv = (n - head) / K;
  const long long tail = head + nv * K;  // first element after the vectors
  const I* vidx = idx + head;
  V* vout = out + head;

  long long v = tid;
  IdxVec<I> k{};
  if (v < nv) k = load_idx(vidx, v);
  const bool h = tid < head, t = tid < n - tail;
  const I hk = h ? idx[tid] : 0;
  const I tk = t ? idx[tail + tid] : 0;
  wait();
  if (h) out[tid] = look(hk);
  if (t) out[tail + tid] = look(tk);
  while (v < nv) {
    const long long next = v + stride;
    IdxVec<I> kn{};
    if (next < nv) kn = load_idx(vidx, next);
    V r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = look(k.k[j]);
    store_out<V, K>(vout, v, r, out_vec);
    k = kn;
    v = next;
  }
}

template <typename I, typename V>
__global__ void __launch_bounds__(kDirectThreads)
    lut_direct(const I* __restrict__ idx, const V* __restrict__ table,
               V* __restrict__ out, long long n, int head, int out_vec) {
  gather(idx, out, n, head, out_vec, [=](I k) { return __ldg(table + k); },
         [] {});
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Dynamic shared memory: the mbarrier in bytes [0, 8), the table from byte
// 16 + (table's address mod 16), so at most 32 + c * sizeof(V) bytes.
template <typename I, typename V>
__global__ void __launch_bounds__(kStagedThreads)
    lut_staged(const I* __restrict__ idx, const V* __restrict__ table,
               V* __restrict__ out, long long n, int c, int head,
               int out_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(table) & 15);
  V* tab = reinterpret_cast<V*>(smem + 16 + mis);
  const uint32_t bar = smem_addr(smem);
  // entries before the table's first 16-byte boundary, the bulk copy's
  // bytes, and the first entry after them
  const int lead = min(c, ((16 - mis) & 15) / static_cast<int>(sizeof(V)));
  const int body = ((c - lead) * static_cast<int>(sizeof(V))) & ~15;
  const int rest = lead + body / static_cast<int>(sizeof(V));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (body > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(body)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(tab + lead)),
          "l"(table + lead), "r"(body), "r"(bar)
          : "memory");
    }
  }
  if (threadIdx.x < lead) tab[threadIdx.x] = table[threadIdx.x];
  if (threadIdx.x < c - rest) tab[rest + threadIdx.x] = table[rest + threadIdx.x];
  gather(idx, out, n, head, out_vec, [=](I k) { return tab[k]; }, [=] {
    __syncthreads();  // the barrier's init and the plain-copied entries
    if (body > 0) mbar_wait(bar, 0);
  });
}

// A device's figures, queried on its first launch only.
struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  int threads_per_sm = 0;
  int smem_per_sm = 0;
  int smem_reserved = 0;  // shared memory the system takes per block
  int smem_optin = 0;     // dynamic shared memory a block may opt in to
  int direct_blocks_per_sm[2][2] = {};  // [int64 idx][int64 table]
};

std::mutex g_mu;
DeviceInfo g_info[kMaxDevices];

template <typename I, typename V>
cudaError_t prepare(DeviceInfo& d) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &d.direct_blocks_per_sm[sizeof(I) == 8][sizeof(V) == 8],
      lut_direct<I, V>, kDirectThreads, 0);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(lut_staged<I, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              d.smem_optin);
}

// Under a lock: the tiled driver's worker threads launch concurrently. The
// caller has made `dev` the current device.
cudaError_t device_info(int dev, DeviceInfo* out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceInfo& d = g_info[dev];
  if (!d.ready) {
    const struct {
      int* value;
      cudaDeviceAttr attr;
    } attrs[] = {
        {&d.sms, cudaDevAttrMultiProcessorCount},
        {&d.threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor},
        {&d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor},
        {&d.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock},
        {&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin}};
    cudaError_t e = cudaSuccess;
    for (const auto& a : attrs)
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(a.value, a.attr, dev);
    if (e == cudaSuccess) e = prepare<int, int>(d);
    if (e == cudaSuccess) e = prepare<int, long long>(d);
    if (e == cudaSuccess) e = prepare<long long, int>(d);
    if (e == cudaSuccess) e = prepare<long long, long long>(d);
    if (e != cudaSuccess) return e;
    d.ready = true;
  }
  *out = d;
  return cudaSuccess;
}

template <typename I, typename V>
cudaError_t launch(const DeviceInfo& d, const void* idx_, const void* table_,
                   void* out_, long long n, int c, int staged,
                   cudaStream_t stream) {
  const I* idx = static_cast<const I*>(idx_);
  const V* table = static_cast<const V*>(table_);
  V* out = static_cast<V*>(out_);
  constexpr int K = IdxVec<I>::K;
  const long long to_aligned =
      ((16 - (reinterpret_cast<uintptr_t>(idx) & 15)) & 15) / sizeof(I);
  const long long head = n < to_aligned ? n : to_aligned;
  const uintptr_t store_bytes = K * sizeof(V) < 16 ? K * sizeof(V) : 16;
  const int out_vec = reinterpret_cast<uintptr_t>(out + head) % store_bytes == 0;
  const long long nv = (n - head) / K;
  long long blocks;
  if (staged) {
    const size_t smem =
        16 + (reinterpret_cast<uintptr_t>(table) & 15) + sizeof(V) * (size_t)c;
    if (smem > (size_t)d.smem_optin) return cudaErrorInvalidValue;
    long long per_sm = d.smem_per_sm / (long long)(smem + d.smem_reserved);
    if (per_sm > d.threads_per_sm / kStagedThreads)
      per_sm = d.threads_per_sm / kStagedThreads;
    blocks = (nv + kStagedThreads - 1) / kStagedThreads;
    if (blocks > d.sms * per_sm) blocks = d.sms * per_sm;
    if (blocks < 1) blocks = 1;
    lut_staged<I, V><<<(int)blocks, kStagedThreads, smem, stream>>>(
        idx, table, out, n, c, (int)head, out_vec);
  } else {
    const long long most =
        (long long)d.sms * d.direct_blocks_per_sm[sizeof(I) == 8][sizeof(V) == 8];
    blocks = (nv + kDirectThreads - 1) / kDirectThreads;
    if (blocks > most) blocks = most;
    if (blocks < 1) blocks = 1;
    lut_direct<I, V><<<(int)blocks, kDirectThreads, 0, stream>>>(
        idx, table, out, n, (int)head, out_vec);
  }
  return cudaGetLastError();
}

}  // namespace

// idx: (n,) int32 or int64 (idx_bytes 4 or 8), every entry in [0, c);
// table: (c,) int32 or int64 (val_bytes); out: (n,) of the table's type;
// all contiguous on `device`, which the caller has made current. `staged`
// picks the route (the table must then fit shared memory). Returns
// cudaGetLastError() after the launch, or an error code for arguments the
// kernel does not take.
extern "C" int lut_gather_launch(const void* idx, int idx_bytes,
                                 const void* table, int val_bytes, void* out,
                                 long long n, long long c, int staged,
                                 int device, void* stream) {
  if ((idx_bytes != 4 && idx_bytes != 8) || (val_bytes != 4 && val_bytes != 8) ||
      n < 0 || c > INT_MAX)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (c < 1) return cudaErrorInvalidValue;
  DeviceInfo d;
  cudaError_t e = device_info(device, &d);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ci = (int)c;
  if (idx_bytes == 4 && val_bytes == 4)
    e = launch<int, int>(d, idx, table, out, n, ci, staged, s);
  else if (idx_bytes == 4)
    e = launch<int, long long>(d, idx, table, out, n, ci, staged, s);
  else if (val_bytes == 4)
    e = launch<long long, int>(d, idx, table, out, n, ci, staged, s);
  else
    e = launch<long long, long long>(d, idx, table, out, n, ci, staged, s);
  return (int)e;
}

// The dynamic shared memory a block on `device` may use, which bounds the
// staged route's table, or minus a CUDA error code. The caller has made
// `device` current.
extern "C" int lut_gather_smem_limit(int device) {
  DeviceInfo d;
  const cudaError_t e = device_info(device, &d);
  return e == cudaSuccess ? d.smem_optin : -(int)e;
}
