// K1: block-local connected-component labelling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _local_ccl_kernel in
// pyshepseg_tpu/ops/pallas_ccl.py (launched by local_ccl_blocks there).
// Same contract: the image (padded to whole blocks) is cut into by x bx
// blocks; every valid pixel (img != ignore) gets the smallest global flat
// index, in the PADDED image, of its connected component inside its block
// (4- or 8-connected, same value); invalid pixels get INT32_MAX.
//
// Bound: device memory traffic, 8 B a pixel (4 B of image read, 4 B of
// labels written). Everything else happens in shared memory and registers.
//
// Design. The TPU kernel iterates neighbour-min plus segmented min-scans
// over a 256x256 block in VMEM. Here one thread block labels one image
// block with a run-based union-find (the scheme of Playne and Hawick's and
// Chen et al.'s block CCL kernels):
//
// 1. Load. A warp owns a 32-pixel column segment of a strip of consecutive
//    rows and walks down it, issuing the next row's load before it works on
//    the current one. The row above stays in registers, so the image is read
//    from device memory once (plus one row per strip and one halo pixel per
//    segment row, which hit L1/L2). Left/right neighbours come from warp
//    shuffles. Image values are never stored: each pixel keeps one byte of
//    flags. __ballot_sync of "same as left" marks the run heads, and
//    __clz on the masked ballot gives each pixel its head, which becomes
//    its parent.
// 2. Union. Only run heads are joined: to the run on the left across a
//    segment edge, and to the runs above (and, 8-connected, diagonally
//    above) that they touch, skipping every join that a neighbour's join
//    already implies. The union-find is lock-free: atomicCAS hooks the
//    larger root under the smaller, so a root is always its tree's
//    smallest local index (and so its smallest flat index); finds halve
//    their paths.
// 3. Flatten. Every run head is pointed at its root, after which every
//    pixel's root is parent[parent[p]]; the labels are written in rows.
//
// Shared memory: a 16-bit parent (a block holds at most 65536 pixels) and a
// flag byte per pixel (3 B, where a 32-bit label and image value take 8),
// with the row stride rounded up to a power of two so that no division is
// needed. A 128x128 block takes 48 KB, so four blocks (2048 threads) share
// an SM; the TPU kernel's 256x256 block fits too (192 KB).
//
// Loads stay 4-byte scalars: one warp's row segment is one coalesced
// 128-byte request, the same device-memory traffic as wider vectors, and
// the shuffles want one pixel a lane.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// per-pixel flags
constexpr unsigned char kValid = 1;
constexpr unsigned char kHead = 2;        // first pixel of its run in a segment
constexpr unsigned char kJoinLeft = 4;    // run continues from the left segment
constexpr unsigned char kJoinUp = 8;
constexpr unsigned char kJoinUpLeft = 16;
constexpr unsigned char kJoinUpRight = 32;
constexpr unsigned char kJoins = kJoinLeft | kJoinUp | kJoinUpLeft | kJoinUpRight;

// One row of a warp's segment: every lane's pixel, and the pixels just left
// of lane 0 and just right of lane 31 (ignore outside the block).
struct Row {
  int v, left_halo, right_halo;
};

__device__ __forceinline__ Row load_row(const int* p, bool in, bool has_left,
                                        bool has_right, int ignore) {
  Row r;
  r.v = in ? __ldg(p) : ignore;
  r.left_halo = has_left ? __ldg(p - 1) : ignore;
  r.right_halo = has_right ? __ldg(p + 1) : ignore;
  return r;
}

__device__ __forceinline__ int left_of(const Row& r, int lane) {
  const int s = __shfl_up_sync(kFull, r.v, 1);
  return lane == 0 ? r.left_halo : s;
}

__device__ __forceinline__ int right_of(const Row& r, int lane) {
  const int s = __shfl_down_sync(kFull, r.v, 1);
  return lane == 31 ? r.right_halo : s;
}

// Root of x, halving the path on the way (every value written is an
// ancestor of x, so concurrent finds and hooks stay correct).
__device__ __forceinline__ int find(volatile unsigned short* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int g = parent[p];
    if (g == p) return p;
    parent[x] = (unsigned short)g;
    x = g;
    p = parent[x];
  }
  return x;
}

// Root of x without writes: while heads are pointed at their roots, a
// halving write could put a stale ancestor back over a finished head.
__device__ __forceinline__ int find_root(const volatile unsigned short* parent,
                                         int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Join the trees of a and b: the larger root is hooked under the smaller,
// only while it still is a root; if another thread hooked it first, the
// loop joins its new tree instead, so no link is lost.
__device__ __forceinline__ void unite(unsigned short* parent, int a, int b) {
  volatile unsigned short* vp = parent;
  while (true) {
    a = find(vp, a);
    b = find(vp, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(parent + b, (unsigned short)b, (unsigned short)a);
    if (old == b) return;
    b = old;
  }
}

template <bool kEight, int kThreads>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    local_ccl_kernel(const int* __restrict__ img, int* __restrict__ out,
                     int width, int by, int bx, int shift, int ignore) {
  extern __shared__ unsigned char smem[];
  const int stride = 1 << shift;
  const int n = by << shift;
  unsigned short* parent = reinterpret_cast<unsigned short*>(smem);
  unsigned char* flags = smem + 2 * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  const int nseg = (bx + 31) >> 5;
  const int groups = nseg >= kWarps ? 1 : kWarps / nseg;
  const int rows = (by + groups - 1) / groups;
  const long long origin =
      (long long)blockIdx.y * by * width + (long long)blockIdx.x * bx;
  const int* blk = img + origin;

  // 1. load, flags and run heads
  for (int t = warp; t < nseg * groups; t += kWarps) {
    const int seg = t % nseg;
    const int y_begin = (t / nseg) * rows;
    const int y_end = min(by, y_begin + rows);
    if (y_begin >= y_end) continue;  // warp-uniform
    const int lx = seg * 32 + lane;
    const bool in = lx < bx;
    const bool has_left = lane == 0 && lx > 0;
    const bool has_right = kEight && lane == 31 && lx + 1 < bx;
    const int* p = blk + (long long)y_begin * width + lx;
    Row above = {ignore, ignore, ignore};
    if (y_begin > 0)
      above = load_row(p - width, in, has_left, has_right, ignore);
    int up = above.v;
    int up_left = left_of(above, lane);
    int up_right = kEight ? right_of(above, lane) : ignore;
    Row cur = load_row(p, in, has_left, has_right, ignore);
    for (int y = y_begin; y < y_end; ++y) {
      Row next = {ignore, ignore, ignore};
      if (y + 1 < y_end)
        next = load_row(p + (long long)(y + 1 - y_begin) * width, in, has_left,
                        has_right, ignore);
      const int v = cur.v;
      const int left = left_of(cur, lane);
      const int right = kEight ? right_of(cur, lane) : ignore;
      const bool valid = in && v != ignore;
      const bool same_left = valid && left == v;
      const bool same_up = valid && up == v;
      const unsigned lm = __ballot_sync(kFull, same_left);
      const unsigned um = __ballot_sync(kFull, same_up);
      // the last lane at or before this one that does not continue a run
      const int head = 31 - __clz((~lm | 1u) & (kFull >> (31 - lane)));
      const int i = (y << shift) + lx;
      if (in) {
        unsigned char f = 0;
        if (valid) {
          f = kValid;
          if (head == lane) f |= kHead;
          if (same_left && lane == 0) f |= kJoinLeft;
          // up: implied when the left pixel of the run joins up already
          const bool left_up = lane > 0 && ((um >> (lane - 1)) & 1u);
          if (same_up && !(same_left && left_up)) f |= kJoinUp;
          if (kEight) {
            // up-left: implied by the up join, or by the left pixel's
            // up join; up-right: by the up join, or by the right pixel's
            const bool right_same = lane < 31 && ((lm >> (lane + 1)) & 1u);
            if (up_left == v && !same_up && !same_left) f |= kJoinUpLeft;
            if (up_right == v && !same_up && !right_same) f |= kJoinUpRight;
          }
        }
        parent[i] = (unsigned short)(i - lane + head);
        flags[i] = f;
      }
      up = v;
      up_left = left;
      up_right = right;
      cur = next;
    }
  }
  __syncthreads();

  // 2. join run heads
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if ((i & (stride - 1)) >= bx) continue;
    const unsigned f = flags[i];
    if (!(f & kJoins)) continue;
    const int h = parent[i];
    if (f & kJoinLeft) unite(parent, h, i - 1);
    if (f & kJoinUp) unite(parent, h, i - stride);
    if (kEight) {
      if (f & kJoinUpLeft) unite(parent, h, i - stride - 1);
      if (f & kJoinUpRight) unite(parent, h, i - stride + 1);
    }
  }
  __syncthreads();

  // 3. flatten: heads point at their roots (every parent is a head); the
  // only writes are these, each of a root, so readers see an ancestor
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if ((i & (stride - 1)) < bx && (flags[i] & kHead))
      parent[i] = (unsigned short)find_root(parent, i);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int lx = i & (stride - 1);
    if (lx >= bx) continue;
    const int ly = i >> shift;
    int label = INT_MAX;
    if (flags[i] & kValid) {
      const int r = parent[parent[i]];
      label = (int)(origin + (long long)(r >> shift) * width + (r & (stride - 1)));
    }
    out[origin + (long long)ly * width + lx] = label;
  }
}

// Launch shape of a (by, bx) block: row stride, its log2, threads and bytes
// of dynamic shared memory (a 16-bit parent and a flag byte per pixel).
struct Shape {
  int shift, threads;
  size_t smem;
};

Shape shape_of(int by, int bx) {
  Shape s;
  s.shift = 0;
  while ((1 << s.shift) < bx) ++s.shift;
  s.smem = 3 * ((size_t)by << s.shift);
  // 512 threads while four blocks share an SM, else 1024 (one or two)
  s.threads = s.smem > 3 * 128 * 128 ? 1024 : 512;
  return s;
}

template <bool kEight, int kThreads>
cudaError_t launch_shape(const int* img, int* out, int h, int w, int by,
                         int bx, const Shape& s, int ignore,
                         cudaStream_t stream) {
  auto* kernel = local_ccl_kernel<kEight, kThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(w / bx, h / by);
  kernel<<<grid, kThreads, s.smem, stream>>>(img, out, w, by, bx, s.shift,
                                             ignore);
  return cudaGetLastError();
}

template <int kThreads>
void* kernel_of(int four_connected) {
  return four_connected ? (void*)local_ccl_kernel<false, kThreads>
                        : (void*)local_ccl_kernel<true, kThreads>;
}

}  // namespace

// img, out: int32 (h, w), row-major, h % by == 0, w % bx == 0,
// h * w < 2^31, by * (bx rounded up to a power of two) <= 65536. Returns
// cudaGetLastError() after the launch, or an error code for a block the
// kernel does not take.
extern "C" int local_ccl_launch(const void* img_, void* out_, int h, int w,
                                int by, int bx, int ignore,
                                int four_connected, void* stream_) {
  if (by < 1 || bx < 1 || h % by || w % bx) return (int)cudaErrorInvalidValue;
  const Shape s = shape_of(by, bx);
  if (((size_t)by << s.shift) > 65536) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  const int* img = static_cast<const int*>(img_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
  if (s.threads == 1024)
    err = four_connected
              ? launch_shape<false, 1024>(img, out, h, w, by, bx, s, ignore, stream)
              : launch_shape<true, 1024>(img, out, h, w, by, bx, s, ignore, stream);
  else
    err = four_connected
              ? launch_shape<false, 512>(img, out, h, w, by, bx, s, ignore, stream)
              : launch_shape<true, 512>(img, out, h, w, by, bx, s, ignore, stream);
  return (int)err;
}

// How a (by, bx) block launches on the current device: threads and bytes of
// dynamic shared memory per block, and the blocks an SM holds at once
// (returned), or minus a CUDA error code.
extern "C" int local_ccl_occupancy(int by, int bx, int four_connected,
                                   int* threads, int* smem) {
  const Shape s = shape_of(by, bx);
  *threads = s.threads;
  *smem = (int)s.smem;
  void* kernel = s.threads == 1024 ? kernel_of<1024>(four_connected)
                                   : kernel_of<512>(four_connected);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        s.threads, s.smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
