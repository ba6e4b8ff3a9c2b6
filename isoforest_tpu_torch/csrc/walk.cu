// Node-id walk of a standard isolation forest, for Hopper (sm_90a).
//
// Replaces the TPU kernel isoforest_tpu/ops/pallas_walk.py::_standard_walk
// (kernel body _standard_walk_kernel). Same function: for every row, the SUM
// over trees of the path length `depth + c(numInstances)` of the leaf the
// row reaches; the caller divides by the real tree count.
//
// What bounds it on this card: issued operations, not bytes. At the 1M-row x
// 100-tree headline the kernel reads X once (24 MB at F=6) and writes 4 MB,
// about 8 us of HBM time, while it does 1e8 row-tree walks of up to h = 8
// dependent steps: read the node's feature id and threshold, pick the row's
// feature value, compare, form the child index, read the child's leaf value.
// Each step waits on the one before, so the walk is a latency chain per
// thread and the card is kept busy by many rows in flight.
//
// What the design does about it:
//  * One thread per row, grid-stride over rows, trees looped inside the
//    thread: the row's sum needs no atomics and adds trees in tree order
//    (the plain version repeats that order, so the two agree bit for bit).
//  * Tables in heap order (child = 2n + 1 + go_right), built on the host:
//    threshold +inf at non-internal slots (the compare then goes left and
//    keeps a finished walk on the hole chain), feature clamped to >= 0 (a
//    safe index), leaf value 0 at internal slots and holes. The TPU's
//    level-major "walk layout" existed only because Mosaic cannot lower the
//    reshape a heap needs; the card does not need it.
//  * A tile of trees is staged in shared memory (48 KB: 8 trees at h = 8),
//    so the dependent reads of a step hit shared memory, not L2. A forest
//    whose single tree does not fit (h >= 12) is read from global memory
//    through L1 instead; there is no height fence.
//  * Rows of up to 16 features keep them in registers and pick x[f] with a
//    select chain; wider rows read x[f] through L1.
//  * A thread stops at the exit leaf (the first slot with a non-zero leaf
//    value): every level after it would add +0.0, so stopping is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegFeatures = 16;
constexpr long long kTileBytes = 48 * 1024;  // default dynamic shared memory limit
constexpr long long kMaxBlocks = 65535;

template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ X, int n, int f_count,
            const float* __restrict__ thr, const int* __restrict__ feat,
            const float* __restrict__ leaf, int t_count, int h, int tile,
            float* __restrict__ out) {
  extern __shared__ float smem[];
  const long long m = (1LL << (h + 1)) - 1;  // heap slots per tree
  float* s_thr = smem;
  int* s_feat = reinterpret_cast<int*>(smem + tile * m);
  float* s_leaf = smem + 2 * tile * m;
  const int step = tile > 0 ? tile : t_count;

  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += (long long)gridDim.x * blockDim.x) {
    const long long row = base + threadIdx.x;
    const bool active = row < n;
    const float* x = X + (active ? row : 0) * (long long)f_count;
    float xr[kRegs ? kRegFeatures : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int k = 0; k < kRegFeatures; ++k) xr[k] = (active && k < f_count) ? x[k] : 0.f;
    }
    float acc = 0.f;
    for (int t0 = 0; t0 < t_count; t0 += step) {
      const int nt = min(step, t_count - t0);
      const float* thr_b = thr + t0 * m;
      const int* feat_b = feat + t0 * m;
      const float* leaf_b = leaf + t0 * m;
      if (tile > 0) {
        __syncthreads();  // the previous tile is no longer read
        for (long long i = threadIdx.x; i < nt * m; i += blockDim.x) {
          s_thr[i] = thr_b[i];
          s_feat[i] = feat_b[i];
          s_leaf[i] = leaf_b[i];
        }
        __syncthreads();
        thr_b = s_thr;
        feat_b = s_feat;
        leaf_b = s_leaf;
      }
      if (!active) continue;
      for (int tt = 0; tt < nt; ++tt) {
        const float* t_thr = thr_b + tt * m;
        const int* t_feat = feat_b + tt * m;
        const float* t_leaf = leaf_b + tt * m;
        int node = 0;
        float lv = t_leaf[0];
        for (int level = 0; level < h && lv == 0.f; ++level) {
          const int f = t_feat[node];
          float xv;
          if constexpr (kRegs) {
            xv = xr[0];
#pragma unroll
            for (int k = 1; k < kRegFeatures; ++k) xv = (f == k) ? xr[k] : xv;
          } else {
            xv = __ldg(x + f);
          }
          // NaN compares false and goes left, as on every JAX path
          node = 2 * node + 1 + (xv >= t_thr[node] ? 1 : 0);
          lv = t_leaf[node];
        }
        acc += lv;
      }
    }
    if (active) out[row] = acc;
  }
}

}  // namespace

// Sum over trees of each row's path length. X: f32[n, f] row-major; thr,
// feat, leaf: [t, 2^(h+1)-1] heap-order tables; out: f32[n]. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int walk_sum(const void* X, int n, int f, const void* thr,
                        const void* feat, const void* leaf, int t, int h,
                        void* out, void* stream) {
  if (n <= 0) return 0;
  if (f <= 0 || t <= 0 || h < 0 || h > 29) return (int)cudaErrorInvalidValue;
  const long long m = (1LL << (h + 1)) - 1;
  const long long fit = kTileBytes / (12 * m);
  const int tile = (int)(fit < t ? fit : t);
  const size_t smem = (size_t)tile * m * 12;
  long long blocks = ((long long)n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* th = static_cast<const float*>(thr);
  const int* fe = static_cast<const int*>(feat);
  const float* lf = static_cast<const float*>(leaf);
  float* o = static_cast<float*>(out);
  if (f <= kRegFeatures) {
    walk_kernel<true><<<(int)blocks, kThreads, smem, s>>>(x, n, f, th, fe, lf, t, h, tile, o);
  } else {
    walk_kernel<false><<<(int)blocks, kThreads, smem, s>>>(x, n, f, th, fe, lf, t, h, tile, o);
  }
  return (int)cudaGetLastError();
}
