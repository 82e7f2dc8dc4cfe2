// K2: gather from a small lookup table for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _lut_kernel in pyshepseg_tpu/ops/lut.py
// (launched by lut_gather / lut_gather_flat there): out[i] = table[idx[i]]
// for a table of at most 32768 entries. Values travel as 32-bit lanes
// (uint32 ids held in int32), so the result is exact.
//
// Design. The TPU kernel loops over 128-lane table rows because Mosaic has
// no general in-VMEM gather. Here each block copies the whole table into
// dynamic shared memory once (at most 128 KB) and then walks its share of
// the indices with 16-byte loads and stores (4 indices a thread), looking
// each one up in shared memory. The host side launches no more blocks than
// the index count needs, since every block pays one full table load.
//
// Bound: device memory traffic — 4 B read and 4 B written per index, plus
// one table load per block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// indices one block should cover before a second block pays off
constexpr long long kPerBlock = kThreads * 4 * 4;

__global__ void lut_gather_kernel(const int* __restrict__ idx,
                                  const int* __restrict__ table,
                                  int* __restrict__ out, long long n, int c,
                                  int vec4) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < c; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    int4* out4 = reinterpret_cast<int4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const int4 k = idx4[i];
      int4 r;
      r.x = tab[k.x];
      r.y = tab[k.y];
      r.z = tab[k.z];
      r.w = tab[k.w];
      out4[i] = r;
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) out[i] = tab[idx[i]];
}

}  // namespace

// idx, out: int32 (n,), contiguous; table: int32 (c,), c <= 32768; every
// idx in [0, c). Returns cudaGetLastError() after the launch.
extern "C" int lut_gather_launch(const void* idx, const void* table,
                                 void* out, long long n, int c,
                                 void* stream) {
  if (n == 0) return 0;
  const size_t smem = sizeof(int) * (size_t)c;
  cudaError_t err = cudaFuncSetAttribute(
      lut_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kPerBlock - 1) / kPerBlock;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  const int vec4 = ((reinterpret_cast<size_t>(idx) |
                     reinterpret_cast<size_t>(out)) % 16) == 0;
  lut_gather_kernel<<<(int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(idx), static_cast<const int*>(table),
      static_cast<int*>(out), n, c, vec4);
  return (int)cudaGetLastError();
}
