// K1: block-local connected-component labelling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _local_ccl_kernel in
// pyshepseg_tpu/ops/pallas_ccl.py (launched by local_ccl_blocks there).
// Same contract: the image (padded to whole blocks) is cut into by x bx
// blocks; every valid pixel (img != ignore) gets the smallest global flat
// index, in the PADDED image, of its connected component inside its block
// (4- or 8-connected, same value); invalid pixels get INT32_MAX.
//
// Design. The TPU kernel iterates neighbour-min plus segmented row/column
// min-scans up to 64 times over a 256x256 block held in VMEM. Here one
// thread block holds its tile in shared memory (4 B image + 4 B parent per
// pixel: 128 KB for the default 128x128 tile, under the 227 KB a block may
// use, hence the dynamic shared memory opt-in) and runs a lock-free
// union-find: every pixel hooks onto its same-valued left/up (and, when
// 8-connected, up-left/up-right) neighbours, always linking the larger
// root under the smaller one with atomicMin, so each root is the smallest
// index of its tree. One pass reaches the full block-local fixpoint, which
// meets the TPU kernel's MAX_LOCAL_ITERS contract trivially.
//
// Bound: device memory traffic — it reads 4 B of image and writes 4 B of
// labels per pixel; the union-find works in shared memory.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Join the trees of a and b; the larger root is hooked under the smaller.
// If another thread re-hooked the root meanwhile, atomicMin returns its new
// parent and the loop joins that one instead, so no link is lost.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void local_ccl_kernel(const int* __restrict__ img,
                                 int* __restrict__ out, int width, int by,
                                 int bx, int ignore, int four_connected) {
  extern __shared__ int smem[];
  const int n = by * bx;
  int* parent = smem;
  int* val = smem + n;
  const int y0 = blockIdx.y * by;
  const int x0 = blockIdx.x * bx;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / bx;
    const int lx = i - ly * bx;
    val[i] = img[(long long)(y0 + ly) * width + x0 + lx];
    parent[i] = i;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = val[i];
    if (v == ignore) continue;
    const int ly = i / bx;
    const int lx = i - ly * bx;
    // a same-valued neighbour of a valid pixel is valid too
    if (lx > 0 && val[i - 1] == v) unite(parent, i, i - 1);
    if (ly > 0) {
      if (val[i - bx] == v) unite(parent, i, i - bx);
      if (!four_connected) {
        if (lx > 0 && val[i - bx - 1] == v) unite(parent, i, i - bx - 1);
        if (lx < bx - 1 && val[i - bx + 1] == v) unite(parent, i, i - bx + 1);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ly = i / bx;
    const int lx = i - ly * bx;
    int label = INT_MAX;
    if (val[i] != ignore) {
      const int r = find_root(parent, i);
      const int ry = r / bx;
      label = (y0 + ry) * width + x0 + (r - ry * bx);
    }
    out[(long long)(y0 + ly) * width + x0 + lx] = label;
  }
}

}  // namespace

// img, out: int32 (h, w), row-major, h % by == 0, w % bx == 0,
// h * w < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int local_ccl_launch(const void* img, void* out, int h, int w,
                                int by, int bx, int ignore,
                                int four_connected, void* stream) {
  const size_t smem = 2 * sizeof(int) * (size_t)by * bx;
  cudaError_t err = cudaFuncSetAttribute(
      local_ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(w / bx, h / by);
  local_ccl_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(img), static_cast<int*>(out), w, by, bx,
      ignore, four_connected);
  return (int)cudaGetLastError();
}
