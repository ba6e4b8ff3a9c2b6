// Gather-free dense level walk of an extended (EIF) isolation forest from
// sparse hyperplane tables, for Hopper (sm_90a).
//
// ext_sparse_mean replaces isoforest_tpu/ops/pallas_traversal.py::
// _extended_pallas_sparse (kernel body _extended_kernel_sparse), which
// serves hyperplanes of k <= 32 coordinates from sparse [k] tables. Its
// sibling for k > 32, the dense-hyperplane kernel, is ext_gemm.cu.
//
// Same function and the same dense nature as that kernel: for every row
// and tree, EVERY internal slot's hyperplane test dot(x, w) >= offset is
// evaluated, the row's path through the tree follows the go-right bits,
// and the exit leaf's merged value (depth + c(numInstances)) is the tree's
// path length. The row's result accumulates `acc += pl / T` tree by tree,
// in tree order, as the TPU kernel's source does (pallas_traversal.py:239).
//
// The dot. The TPU kernel takes dots = X @ W with W the densified
// hyperplanes; XLA:CPU (the reference in interpret mode) computes each dot
// as an FMA chain over features in ascending order from 0, and a zero
// weight leaves an FMA chain unchanged on a finite row. So the kernel
// computes acc = fma(x[f], w, acc) from acc = 0 over the node's coordinates
// in ascending feature order, duplicates merged on the host as np.add.at
// merges them, each step pinned with __fmaf_rn. On finite rows this is the
// reference's dot bit for bit. On rows with NaN or +-inf the product would
// make the dot NaN at every slot whatever the node's coordinates; here only
// the node's own coordinates enter, plus x[0]*0 for each unused coordinate,
// as in the gather walk, so such rows route like the gather walk. In the
// sparse tables an unused coordinate is (0, 0.0), one x[0]*0 term, and
// a coordinate that a merge removed is index -1, placed last: it was never
// unused, so it adds no x[0]*0, and the node's terms end at the first -1.
// No tensor cores and no library product: every product is an FP32 FMA on
// the CUDA cores, so nothing rounds through TF32.
//
// What bounds it on this card: issued operations. The dense algorithm
// evaluates all 2^h - 1 internal-capable slots per row and tree (255 at
// h = 8), each k FMAs with a table read and a feature read each: 1.5e11
// FMAs at 1M rows x 100 trees x k = 6. The function itself needs only the
// slots on each row's path, as the walk (ext_walk.cu) evaluates.
//
// What the design does about it:
//  * One thread per row, grid-stride over row tiles of one block. Every
//    thread of a block evaluates the same slot at the same time, so table
//    reads are warp-wide broadcasts through L1 (__ldg).
//  * The block's rows are staged in shared memory feature-major
//    (x_s[f * B + thread]), so the feature read of a term is a
//    conflict-free shared-memory load whatever the coordinate. The tile
//    takes F * B * 4 bytes; B (256 down to 32 rows) is the largest that
//    fits kMaxTileBytes, and only rows wider than that read x[f] through
//    L1. Measured on the H100 at the main path's shape
//    (tools/torch_port_kernel_paths.py), the tile beats L1 reads by a few
//    percent at F = 6.
//  * A level's go-right bits are packed 32 slots to a word in a per-thread
//    array (32 words at the height fence), then the row's path follows the
//    bits: at most one slot per level is reached, so the tree's path length
//    is the exit leaf's value exactly.
//  * `pl / T` is a true division (no --use_fast_math).
//
// Height fence: kMaxHeight = 10, the standard dense kernel's (dense.cu),
// which keeps the bit array at 32 words. The wrapper raises a ValueError
// above it; the walk kernel has no fence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxHeight = 10;
constexpr int kMaxWords = (1 << kMaxHeight) / 32;
constexpr long long kMaxTileBytes = 100 * 1024;
constexpr long long kMaxBlocks = 65535;

template <bool kSmemX>
__device__ __forceinline__ float feature(const float* x_s, const float* x, int f, int b) {
  if constexpr (kSmemX) {
    return x_s[f * b + threadIdx.x];
  } else {
    return __ldg(x + f);
  }
}

// index i32 and weight f32 [t, 2^h - 1, width], width = k.
template <bool kSmemX>
__global__ void __launch_bounds__(kMaxThreads)
ext_dense_kernel(const float* __restrict__ X, int n, int f_count,
                 const float* __restrict__ value, const int* __restrict__ kind,
                 const int* __restrict__ index, const float* __restrict__ weight,
                 int width, int t_count, int h, float* __restrict__ out) {
  extern __shared__ float x_s[];
  const int b = blockDim.x;
  const long long m = (1LL << (h + 1)) - 1;  // heap slots per tree
  const int m_int = (1 << h) - 1;            // slots above the bottom level
  const int words = (m_int + 31) / 32;
  const float t_real = (float)t_count;

  for (long long base = (long long)blockIdx.x * b; base < n; base += (long long)gridDim.x * b) {
    const long long row = base + threadIdx.x;
    const bool active = row < n;
    const float* x = X + (active ? row : 0) * (long long)f_count;
    if constexpr (kSmemX) {
      __syncthreads();  // the previous tile is no longer read
      for (long long i = threadIdx.x; i < (long long)b * f_count; i += b) {
        const long long r = i / f_count;
        const int f = (int)(i - r * f_count);
        x_s[f * b + r] = base + r < n ? X[(base + r) * f_count + f] : 0.f;
      }
      __syncthreads();
    }
    if (!active) continue;
    float acc = 0.f;
    for (int t = 0; t < t_count; ++t) {
      const float* t_val = value + t * m;
      const int* t_kind = kind + t * m;
      uint32_t right[kMaxWords];
      for (int w = 0; w < words; ++w) {
        uint32_t bits = 0u;
        for (int j = 0; j < 32; ++j) {
          const int s = 32 * w + j;
          if (s >= m_int) break;
          const int kd = __ldg(t_kind + s);
          if (kd == 0) continue;
          const long long row0 = ((long long)t * m_int + s) * width;
          float dot = 0.f;
          for (int q = 0; q < width; ++q) {
            const int f = __ldg(index + row0 + q);
            if (f < 0) break;  // merged away, and so are the rest
            dot = __fmaf_rn(feature<kSmemX>(x_s, x, f, b), __ldg(weight + row0 + q), dot);
          }
          // NaN compares false and goes left, as on every JAX path
          bits |= (uint32_t)(dot >= __ldg(t_val + s)) << j;
        }
        right[w] = bits;
      }
      int node = 0;
      while (node < m_int && __ldg(t_kind + node) != 0) {
        node = 2 * node + 1 + (int)((right[node >> 5] >> (node & 31)) & 1u);
      }
      acc += __ldg(t_val + node) / t_real;
    }
    out[row] = acc;
  }
}

int launch(const float* x, int n, int f, const float* val, const int* kd, const int* ix,
           const float* w, int width, int t, int h, float* o, cudaStream_t s) {
  int b = kMaxThreads;
  while (b > 32 && (long long)f * b * 4 > kMaxTileBytes) b /= 2;
  const bool smem_x = (long long)f * b * 4 <= kMaxTileBytes;
  long long blocks = ((long long)n + b - 1) / b;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (smem_x) {
    const size_t smem = (size_t)f * b * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(ext_dense_kernel<true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    ext_dense_kernel<true><<<(int)blocks, b, smem, s>>>(x, n, f, val, kd, ix, w, width, t, h, o);
  } else {
    ext_dense_kernel<false><<<(int)blocks, b, 0, s>>>(x, n, f, val, kd, ix, w, width, t, h, o);
  }
  return (int)cudaGetLastError();
}

int check_args(int n, int f, int t, int h, int width) {
  if (h < 0 || h > kMaxHeight || f <= 0 || t <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  return n < 0 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// Mean path length over trees, accumulated as sum of pl / t in tree order,
// from sparse hyperplanes. X: f32[n, f] row-major; value (f32 merged plane)
// and kind (i32: 0 non-internal, 1 internal) [t, 2^(h+1)-1] in heap order;
// index (i32) and weight (f32) [t, 2^h - 1, k]: each node's coordinates in
// ascending order, then unused ones as (0, 0.0), then merged-away ones as
// (-1, 0.0), where the node's terms end; out: f32[n]. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int ext_sparse_mean(const void* X, int n, int f, const void* value, const void* kind,
                               const void* index, const void* weight, int k, int t, int h,
                               void* out, void* stream) {
  const int bad = check_args(n, f, t, h, k);
  if (bad || n == 0) return bad;
  return launch(static_cast<const float*>(X), n, f, static_cast<const float*>(value),
                static_cast<const int*>(kind), static_cast<const int*>(index),
                static_cast<const float*>(weight), k, t, h, static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}
