// Node-id walk of an extended (EIF) isolation forest, for Hopper (sm_90a).
//
// Replaces the TPU kernel isoforest_tpu/ops/pallas_walk.py::_extended_walk
// (kernel body _extended_walk_kernel). Same function: for every row, the SUM
// over trees of the path length `depth + c(numInstances)` of the leaf the
// row reaches, where a node sends the row right when the hyperplane dot
// x[idx_0]*w_0 + ... + x[idx_{k-1}]*w_{k-1} >= offset. The caller divides
// by the real tree count.
//
// The dot's rounding order is the point of this kernel. On quantized data
// `dot == offset` holds exactly at many deep nodes, so one ulp decides the
// child. Each step is pinned with __fmul_rn / __fmaf_rn (nvcc would
// otherwise contract freely), in the order XLA gives the reference:
//  * k <= kPairedMaxK (16, the TPU kernel's own k fence): the order XLA:CPU
//    gives `_extended_walk`'s jnp.sum(jnp.stack(terms)): d = x1*w1, then
//    d = fma(x0, w0, d), then d = fma(xq, wq, d) for q = 2..k-1;
//  * k > 16, where the reference's walk kernel does not go and the port is
//    held to the gather walk: the gather walk's order, d = fma(xq, wq, d)
//    from d = 0 for q = 0..k-1.
// (k = 1 is x0*w0 in both.) Unused coordinates carry index 0 and weight 0,
// so they add x[0]*0: nothing on finite rows, NaN where x[0] is not finite,
// exactly as in the reference.
//
// What bounds it on this card: issued operations. At the 1M-row x 100-tree
// headline (k = 6, F = 6) the kernel reads X once (24 MB) and writes 4 MB,
// about 8 us of HBM time, while each of the 1e8 row-tree walks takes up to
// h = 8 dependent steps of k table reads, k feature reads and k FMAs.
//
// What the design does about it:
//  * One thread per row, grid-stride over rows, trees looped inside the
//    thread in tree order (the plain version repeats the order, so the two
//    agree bit for bit).
//  * Heap-order tables built on the host: offset +inf at non-internal slots
//    (a finished walk keeps going left on the hole chain), node-major
//    [M][k] coordinates and weights, leaf value 0 at internal slots and
//    holes. No TPU walk layout. There is no k or height fence.
//  * Rows and tables are plain global loads, cached in L1. On the H100 at
//    the 1M-row headline this beats keeping a row in registers (a select
//    chain per read), staging trees in shared memory, and reading through
//    the read-only path (__ldg), whose longer latency each dependent step
//    pays (tools/torch_port_kernel_paths.py times the last).
//  * A thread stops at the exit leaf (the first slot with a non-zero leaf
//    value): every level after it would add +0.0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairedMaxK = 16;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kThreads)
ext_walk_kernel(const float* __restrict__ X, int n, int f_count,
                const float* __restrict__ off, const int* __restrict__ idx,
                const float* __restrict__ w, const float* __restrict__ leaf,
                int t_count, int h, int k, float* __restrict__ out) {
  const long long m = (1LL << (h + 1)) - 1;  // heap slots per tree
  const bool paired = k > 1 && k <= kPairedMaxK;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (long long)gridDim.x * blockDim.x) {
    const float* x = X + row * (long long)f_count;
    float acc = 0.f;
    for (int t = 0; t < t_count; ++t) {
      const float* t_off = off + t * m;
      const float* t_leaf = leaf + t * m;
      const float* t_w = w + t * m * k;
      const int* t_idx = idx + t * m * k;
      int node = 0;
      float lv = t_leaf[0];
      for (int level = 0; level < h && lv == 0.f; ++level) {
        const int* ni = t_idx + (long long)node * k;
        const float* nw = t_w + (long long)node * k;
        float dot;
        int q;
        if (paired) {
          dot = __fmul_rn(x[ni[1]], nw[1]);
          dot = __fmaf_rn(x[ni[0]], nw[0], dot);
          q = 2;
        } else {
          dot = 0.f;
          q = 0;
        }
        for (; q < k; ++q) dot = __fmaf_rn(x[ni[q]], nw[q], dot);
        // NaN compares false and goes left, as on every JAX path
        node = 2 * node + 1 + (dot >= t_off[node] ? 1 : 0);
        lv = t_leaf[node];
      }
      acc += lv;
    }
    out[row] = acc;
  }
}

}  // namespace

// Sum over trees of each row's path length. X: f32[n, f] row-major; off,
// leaf: f32[t, 2^(h+1)-1]; idx: i32 and w: f32 [t, 2^(h+1)-1, k], all in
// heap order; out: f32[n]. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int ext_walk_sum(const void* X, int n, int f, const void* off,
                            const void* idx, const void* w, const void* leaf,
                            int t, int h, int k, void* out, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || t <= 0 || k <= 0 || h < 0 || h > 29) return (int)cudaErrorInvalidValue;
  long long blocks = ((long long)n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ext_walk_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n, f, static_cast<const float*>(off), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float*>(leaf), t, h, k, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
