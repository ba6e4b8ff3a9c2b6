// Path walks of an extended (EIF) isolation forest, for Hopper (sm_90a):
// the two kernels that score rows through the hyperplanes on each row's
// path, on one walk core.
//
// ext_walk_sum replaces isoforest_tpu/ops/pallas_walk.py::_extended_walk
// (kernel body _extended_walk_kernel): for every row, the SUM over trees
// of the path length `depth + c(numInstances)` of the leaf the row
// reaches; the caller divides by the real tree count.
//
// ext_sparse_mean replaces isoforest_tpu/ops/pallas_traversal.py::
// _extended_pallas_sparse (kernel body _extended_kernel_sparse), the dense
// level walk for hyperplanes of k <= 32 coordinates: for every row, the
// MEAN path length, accumulated `acc += pl / T` tree by tree in tree order
// as the TPU kernel's source does (pallas_traversal.py:239), `/` a true
// division. The TPU kernel evaluates every slot's hyperplane, because
// Mosaic has no cheap per-row gather, and then follows the go-right bits;
// only the bits on the row's path are ever read, so evaluating only the
// slots on the path, each dot computed exactly as there, gives the same
// result bit for bit. ops/ext_dense.py's plain version still evaluates
// every slot, and the kernel is held to it on the card.
//
// A node sends the row right when dot >= offset (NaN compares false and
// goes left, as on every JAX path). The dot's rounding order is the point:
// on quantized data `dot == offset` holds exactly at many deep nodes, so
// one ulp decides the child. Each step is pinned with __fmul_rn /
// __fmaf_rn (nvcc would otherwise contract freely):
//  * ext_walk_sum, 1 < k <= kPairedMaxK (16, the TPU walk kernel's own k
//    fence): the order XLA:CPU gives _extended_walk's
//    jnp.sum(jnp.stack(terms)): d = x1*w1, then d = fma(x0, w0, d), then
//    d = fma(xq, wq, d) for q = 2..k-1;
//  * otherwise (ext_walk_sum at k = 1 or k > 16, where it is held to the
//    gather walk, and ext_sparse_mean always, whose reference's X @ W
//    XLA:CPU computes as an FMA chain over features in ascending order):
//    d = fma(xq, wq, d) from d = 0 over the node's terms.
// A term is (feature, weight). ext_walk_sum's node has k terms, an unused
// coordinate being (0, 0.0): x[0]*0, nothing on a finite row, NaN where
// x[0] is not finite, as in the reference. ext_sparse_mean's node has its
// merged coordinates in ascending order, then one (0, 0.0) per unused one;
// a coordinate that a duplicate merge removed is no term at all (the host
// counts the terms, ops/ext_path.py).
//
// What bounds both kernels on this card: the chain of dependent latencies
// in each level (the record's loads, then the row's features, then the
// FMA chain, then the compare that picks the next record) and the issued
// instructions, not memory bandwidth. The heap tables cost 2k + 2 scalar
// loads a level in the walk, and the sparse kernel evaluated all 2^h - 1
// slots of a tree with three dependent loads an FMA. What this design does
// about it:
//  * One record per internal node, in 16-byte chunks, in a compact
//    per-tree order (the tree's internal heap slots in ascending order, so
//    the top levels sit together): a header int4 (offset, left child, right
//    child, term count), then the terms, three to a chunk (three weights
//    and their three 10-bit feature indices in the fourth word) where F <=
//    1024, else two to a chunk (two weights, two i32 indices). A child code
//    < 0 is ~record of an internal node; >= 0 is the bits of the leaf's
//    path length (>= +0.0), so a leaf costs no load. One level at k = 6 is
//    three independent 16-byte loads instead of 2k + 2 dependent scalar
//    ones, and the mammography forest's records take 200 KB instead of
//    2.9 MB of heap tables. The records are read through the read-only
//    path (__ldg): they never change during a launch.
//  * Bulk batches: one row a thread (two or three rows a thread, walked
//    interleaved, measured slower), trees in tree order inside the thread.
//    The block's rows are staged feature-major in shared memory
//    (x_s[f * kTileRows + row]): a term's feature read is a conflict-free
//    shared-memory load whatever its feature. Rows wider than
//    kMaxTileFeatures read x[f] through L1.
//  * Small batches (the host picks them below a measured row count,
//    ops/ext_path.py): one warp per row, lanes over trees, 32 trees a
//    round; each lane's path length is broadcast with __shfl_sync and every
//    lane adds them in tree order: the same sum in the same order, exact.
// tools/torch_port_kernel_paths.py times each of these choices against
// its alternative on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileRows = kThreads;  // rows of a block's tile (bulk)
constexpr int kMaxTileFeatures = 48;  // x tile F * kTileRows * 4 bytes <= 48 KB
constexpr int kWarps = kThreads / 32;  // rows per block (small batches)
constexpr int kPairedMaxK = 16;
constexpr long long kMaxBlocks = 65535;

struct Records {
  const int4* rec;   // [R, 1 + chunks] int4
  const int* roots;  // [T] child code of each tree's root
  int chunks;        // term chunks per record: ceil(k / terms a chunk)
  int t_count;
  bool paired;
};

// One level: the hyperplane test of record `node` on the row x_at reads;
// returns the child code. kTerms: terms a chunk, 3 (10-bit indices) or 2
// (i32 indices).
template <int kTerms, typename XAt>
__device__ __forceinline__ int step(const Records& F, int node, XAt x_at) {
  const int4* r = F.rec + (long long)node * (1 + F.chunks);
  const int4 head = __ldg(r);
  const int terms = head.w;
  float dot = 0.f;
#pragma unroll 2
  for (int c = 0; c < F.chunks; ++c) {
    const int4 v = __ldg(r + 1 + c);
    const float w0 = __int_as_float(v.x), w1 = __int_as_float(v.y);
    int i0, i1;
    if constexpr (kTerms == 3) {
      i0 = v.w & 0x3ff;
      i1 = (v.w >> 10) & 0x3ff;
    } else {
      i0 = v.z;
      i1 = v.w;
    }
    const int q = kTerms * c;
    if (q == 0 && F.paired) {  // k >= 2 terms
      dot = __fmul_rn(x_at(i1), w1);
      dot = __fmaf_rn(x_at(i0), w0, dot);
    } else {
      if (q < terms) dot = __fmaf_rn(x_at(i0), w0, dot);
      if (q + 1 < terms) dot = __fmaf_rn(x_at(i1), w1, dot);
    }
    if constexpr (kTerms == 3) {
      if (q + 2 < terms) dot = __fmaf_rn(x_at((v.w >> 20) & 0x3ff), __int_as_float(v.z), dot);
    }
  }
  return dot >= __int_as_float(head.x) ? head.z : head.y;
}

template <bool kMean>
__device__ __forceinline__ void add_tree(float& acc, float pl, float t_real) {
  if constexpr (kMean) {
    acc += pl / t_real;
  } else {
    acc += pl;
  }
}

// Bulk batches: one row a thread, trees in order inside the thread.
template <bool kMean, int kTerms, bool kSmemX>
__global__ void __launch_bounds__(kThreads)
path_rows_kernel(const float* __restrict__ X, int n, int f_count, Records F, float* __restrict__ out) {
  extern __shared__ float x_s[];
  const float t_real = (float)F.t_count;
  for (long long base = (long long)blockIdx.x * kTileRows; base < n;
       base += (long long)gridDim.x * kTileRows) {
    if constexpr (kSmemX) {
      __syncthreads();  // the previous tile is no longer read
      const long long here = n - base < kTileRows ? n - base : kTileRows;
      const float* src = X + base * f_count;
      for (int i = threadIdx.x; i < kTileRows * f_count; i += kThreads) {
        const int r = i / f_count;
        x_s[(i - r * f_count) * kTileRows + r] = r < here ? src[i] : 0.f;
      }
      __syncthreads();
    }
    const long long row = base + threadIdx.x;
    if (row >= n) continue;
    const float* xr = X + row * f_count;
    const float* xs = x_s + threadIdx.x;
    const auto x_at = [&](int f) {
      if constexpr (kSmemX) {
        return xs[f * kTileRows];
      } else {
        return xr[f];
      }
    };
    float acc = 0.f;
    for (int t = 0; t < F.t_count; ++t) {
      int code = F.roots[t];
      while (code < 0) code = step<kTerms>(F, ~code, x_at);
      add_tree<kMean>(acc, __int_as_float(code), t_real);
    }
    out[row] = acc;
  }
}

// Small batches: one warp per row, lane l walks trees l, l + 32, ...
template <bool kMean, int kTerms>
__global__ void __launch_bounds__(kThreads)
path_trees_kernel(const float* __restrict__ X, int n, int f_count, Records F, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float t_real = (float)F.t_count;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < n; row += warps) {
    const float* x = X + row * f_count;
    float acc = 0.f;
    for (int t0 = 0; t0 < F.t_count; t0 += 32) {
      int code = t0 + lane < F.t_count ? F.roots[t0 + lane] : 0;
      while (code < 0) code = step<kTerms>(F, ~code, [&](int f) { return x[f]; });
      const float pl = __int_as_float(code);
      const int here = F.t_count - t0 < 32 ? F.t_count - t0 : 32;
      for (int j = 0; j < here; ++j) add_tree<kMean>(acc, __shfl_sync(0xffffffffu, pl, j), t_real);
    }
    if (lane == 0) out[row] = acc;
  }
}

template <bool kMean, int kTerms>
void launch_terms(const float* X, int n, int f, const Records& F, bool tree_parallel, float* out, cudaStream_t s) {
  if (tree_parallel) {
    long long blocks = ((long long)n + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    path_trees_kernel<kMean, kTerms><<<(int)blocks, kThreads, 0, s>>>(X, n, f, F, out);
    return;
  }
  long long blocks = ((long long)n + kTileRows - 1) / kTileRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (f <= kMaxTileFeatures) {
    path_rows_kernel<kMean, kTerms, true>
        <<<(int)blocks, kThreads, (size_t)f * kTileRows * sizeof(float), s>>>(X, n, f, F, out);
  } else {
    path_rows_kernel<kMean, kTerms, false><<<(int)blocks, kThreads, 0, s>>>(X, n, f, F, out);
  }
}

template <bool kMean>
int launch(const void* X, int n, int f, const void* records, const void* roots, int t, int k,
           int terms_per_chunk, int tree_parallel, void* out, void* stream) {
  if (n < 0 || f <= 0 || t <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Records F{static_cast<const int4*>(records), static_cast<const int*>(roots),
                  (k + terms_per_chunk - 1) / terms_per_chunk, t, !kMean && k > 1 && k <= kPairedMaxK};
  const float* x = static_cast<const float*>(X);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = tree_parallel != 0;
  switch (terms_per_chunk) {
    case 3: launch_terms<kMean, 3>(x, n, f, F, small, o, s); break;
    case 2: launch_terms<kMean, 2>(x, n, f, F, small, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries: X f32[n, f] row-major; records int32 [R, 4 * (1 + chunks)],
// 16-byte aligned, and roots int32 [t] as ops/ext_path.py builds them, with
// k terms at most per record, terms_per_chunk (3 or 2) to a chunk;
// tree_parallel != 0 takes the small-batch kernel (one warp a row); out
// f32[n]. Each launches on `stream` and returns cudaGetLastError() of the
// launch.

// Sum over trees of each row's path length, in the walk kernel's dot order.
extern "C" int ext_walk_sum(const void* X, int n, int f, const void* records, const void* roots, int t, int k,
                            int terms_per_chunk, int tree_parallel, void* out, void* stream) {
  return launch<false>(X, n, f, records, roots, t, k, terms_per_chunk, tree_parallel, out, stream);
}

// Mean path length over trees (sum of pl / t in tree order), in the sparse
// kernel's dot order.
extern "C" int ext_sparse_mean(const void* X, int n, int f, const void* records, const void* roots, int t,
                               int k, int terms_per_chunk, int tree_parallel, void* out, void* stream) {
  return launch<true>(X, n, f, records, roots, t, k, terms_per_chunk, tree_parallel, out, stream);
}
