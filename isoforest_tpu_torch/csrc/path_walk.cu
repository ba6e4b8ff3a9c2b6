// Path walks of isolation forests, for Hopper (sm_90a): the three kernels
// that score rows by walking each tree from its root to the leaf the row
// reaches, on one walk core over compact per-node records.
//
// walk_sum replaces isoforest_tpu/ops/pallas_walk.py::_standard_walk
// (kernel body _standard_walk_kernel), the walk of a standard forest, and
// ext_walk_sum replaces isoforest_tpu/ops/pallas_walk.py::_extended_walk
// (kernel body _extended_walk_kernel), the walk of an extended (EIF)
// forest: for every row, the SUM over trees, in tree order, of the path
// length `depth + c(numInstances)` of the leaf the row reaches; the caller
// divides by the real tree count.
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
// A standard node sends the row right when x[feature] >= threshold, an EIF
// node when dot >= offset (NaN compares false and goes left, as on every
// JAX path). The dot's rounding order is the point: on quantized data
// `dot == offset` holds exactly at many deep nodes, so one ulp decides the
// child. Each step is pinned with __fmul_rn / __fmaf_rn (nvcc would
// otherwise contract freely):
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
// What bounds the three kernels on this card: the chain of dependent
// latencies in each level (the record's loads, then the row's feature or
// features, then for an EIF node the FMA chain, then the compare that picks
// the next record) and the issued instructions, not memory bandwidth: at 1M
// rows x 100 trees the standard walk reads 24 MB of X and does about 7.5e8
// levels. Heap tables cost dependent scalar loads a level (the standard
// walk's three: feature, threshold, then the child's leaf value; the EIF
// walk's 2k + 2), and a standard forest's heap tables are 90% holes. What
// this design does about it:
//  * One record per internal node, in 16-byte chunks, in a compact
//    per-tree order (the tree's internal heap slots in ascending order, so
//    the top levels sit together): a header int4 (threshold or offset, left
//    child, right child, feature or term count), then for an EIF node its
//    terms, three to a chunk (three weights and their three 10-bit feature
//    indices in the fourth word) where F <= 1024, else two to a chunk (two
//    weights, two i32 indices). A standard node's record is the header
//    alone. A child code < 0 is ~record of an internal node; >= 0 is the
//    bits of the leaf's path length (>= +0.0), so a leaf costs no load and
//    the walk needs no height. A standard level is one 16-byte load, one
//    feature read, a compare and a select; the mammography forest's 5,168
//    records take 83 KB instead of 613 KB of heap tables. An EIF level at
//    k = 6 is three independent 16-byte loads instead of 2k + 2 dependent
//    scalar ones (200 KB of records instead of 2.9 MB). The records are
//    read through the read-only path (__ldg): they never change during a
//    launch.
//  * Bulk batches: one row a thread (two or three rows a thread, walked
//    interleaved, measured slower), trees in tree order inside the thread.
//    The block's rows are staged feature-major in shared memory
//    (x_s[f * kTileRows + row]): a feature read is a conflict-free
//    shared-memory load whatever its feature (no select chain over a row
//    kept in registers). Rows wider than kMaxTileFeatures read x[f] through
//    L1.
//  * The standard walk's bulk batches, where two blocks of kStageThreads
//    threads fit an SM with a group of whole trees' records and the row
//    tile in shared memory (the mammography forest, one group: 83 KB +
//    24 KB a block) and the rows fill two such blocks on every SM:
//    persistent blocks stage each group's records and read every level
//    from shared memory (walk_staged_kernel); the same walk with its
//    records through __ldg measured 1.13x slower (L1 misses and L1's
//    longer latency are not told apart). On the H100 (228 KB of shared
//    memory an SM, 1 KB of it reserved a block) a block may take 115,712
//    bytes, so a group holds at most (115,712 - 4,096 F) / 16 = 7,232 -
//    256 F records: 6,464 at F = 3 (a 100-tree KDDCup99-HTTP forest holds
//    about 6,300, one group), none from F = 29 on (staged_budget). The
//    host cuts the forest into groups of consecutive whole trees within
//    that budget (ops/ext_path.py), once a forest; a 1000-tree HTTP
//    forest's 61,000 records (1 MB) make about ten. A block walks its row
//    tile through the groups in order, staging each in turn, and adds
//    every tree's path length to one sum, tree 0 to T - 1, as the other
//    launches do: the scores stay bitwise. A forest of one group is
//    staged once a block, not once a tile. The group bounds travel as
//    kernel parameters, kMaxGroups of them a launch (a forest of more
//    groups takes one launch for each kMaxGroups, each continuing the
//    sums). On an H100 a 100-tree forest's launches, ten back to back,
//    took 0.9989-1.0015x the whole-forest walk this one replaced with room
//    for 16 groups, 1.0015-1.0048x with room for 128
//    (tools/torch_port_kernel_paths.py --grouped-walk). A tree over the
//    budget, a wider row or fewer rows take the core's bulk kernel
//    (path_rows_kernel, records through __ldg). Each launch reports which
//    of the four it took (Variant), and ops/ext_path.py counts it in
//    isoforest_walk_launches_total{kernel, variant}.
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
constexpr int kStageThreads = 1024;  // rows a block of the staged standard walk
constexpr long long kMaxBlocks = 65535;
constexpr int kMaxGroups = 16;  // tree groups a launch of the staged walk takes (kernel parameters)

struct Records {
  const int4* rec;   // [R, 1 + chunks] int4
  const int* roots;  // [T] child code of each tree's root
  int chunks;        // term chunks per record: ceil(k / terms a chunk), 0 for a standard node
  int t_count;
  bool paired;
};

// The staged walk's tree groups, passed by value: group g is trees
// [tree[g], tree[g + 1]) and their records [record[g], record[g + 1]).
struct Groups {
  int count;
  int tree[kMaxGroups + 1];
  int record[kMaxGroups + 1];
};

// One level: the test of record `node` on the row x_at reads; returns the
// child code. kTerms: terms a chunk, 3 (10-bit indices) or 2 (i32
// indices), or 0 for a standard node's header-only record.
template <int kTerms, typename XAt>
__device__ __forceinline__ int step(const Records& F, int node, XAt x_at) {
  const int4* r = F.rec + (long long)node * (kTerms == 0 ? 1 : 1 + F.chunks);
  const int4 head = __ldg(r);
  if constexpr (kTerms == 0) {  // (threshold, left, right, feature)
    return x_at(head.w) >= __int_as_float(head.x) ? head.z : head.y;
  } else {
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

// Bulk batches of a standard forest (header-only records), walked group by
// group: for each row tile, each group's records staged in shared memory
// (once for all the block's tiles where the forest is one group), then its
// trees walked, one row a thread, trees in order, into the same sum. A
// child code inside a group is rebased by the group's first record.
// `carry` continues the sums in `out`: a launch after the first, for a
// forest of more than kMaxGroups groups.
__global__ void __launch_bounds__(kStageThreads, 2)
walk_staged_kernel(const float* __restrict__ X, int n, int f_count, Records F, Groups G, int r_max, bool carry,
                   float* __restrict__ out) {
  extern __shared__ int4 rec_s[];
  float* x_s = reinterpret_cast<float*>(rec_s + r_max);
  const auto stage = [&](int g) {
    const int4* src = F.rec + G.record[g];
    const int r = G.record[g + 1] - G.record[g];
    for (int i = threadIdx.x; i < r; i += kStageThreads) rec_s[i] = __ldg(src + i);
  };
  const bool once = G.count == 1;
  if (once) stage(0);
  for (long long base = (long long)blockIdx.x * kStageThreads; base < n;
       base += (long long)gridDim.x * kStageThreads) {
    __syncthreads();  // the records are staged; the previous tile is no longer read
    const long long here = n - base < kStageThreads ? n - base : kStageThreads;
    const float* src = X + base * f_count;
    for (int i = threadIdx.x; i < kStageThreads * f_count; i += kStageThreads) {
      const int j = i / f_count;
      x_s[(i - j * f_count) * kStageThreads + j] = j < here ? src[i] : 0.f;
    }
    if (!once) stage(0);
    __syncthreads();
    const long long row = base + threadIdx.x;
    const bool live = row < n;
    const float* xs = x_s + threadIdx.x;
    float acc = carry && live ? out[row] : 0.f;
    for (int g = 0; g < G.count; ++g) {
      if (g > 0) {
        __syncthreads();  // the previous group is no longer read
        stage(g);
        __syncthreads();
      }
      if (!live) continue;
      const int r0 = G.record[g];
      for (int t = G.tree[g]; t < G.tree[g + 1]; ++t) {
        int code = F.roots[t];
        while (code < 0) {
          const int4 head = rec_s[~code - r0];  // (threshold, left, right, feature)
          code = xs[head.w * kStageThreads] >= __int_as_float(head.x) ? head.z : head.y;
        }
        acc += __int_as_float(code);
      }
    }
    if (live) out[row] = acc;
  }
}

// The launch a batch takes, as each entry reports it (ops/ext_path.py
// names them in this order).
enum Variant : int {
  kStaged = 0,  // walk_staged_kernel: the records, a group of trees at a time, and the row tile in shared memory
  kTile = 1,    // path_rows_kernel: the row tile in shared memory, records through __ldg
  kGlobal = 2,  // path_rows_kernel: rows wider than kMaxTileFeatures, x[f] through L1
  kTrees = 3,   // path_trees_kernel: one warp a row
};

// Blocks of the staged walk with `bytes` of shared memory each that the card
// holds at once, where two of them fit an SM (so that their 2 x
// kStageThreads threads fill it); 0 where not. Sets the kernel's limit to
// `bytes`.
long long staged_grid(size_t bytes) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || bytes > (size_t)optin ||
      cudaFuncSetAttribute(walk_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_staged_kernel, kStageThreads, bytes) !=
          cudaSuccess || per_sm < 2)
    return 0;
  return (long long)per_sm * sms;
}

// A staged block's shared memory: r records and a row tile of width f.
size_t staged_bytes(int f, int r) { return (size_t)r * sizeof(int4) + (size_t)f * kStageThreads * sizeof(float); }

// The most records a group of the staged walk may hold beside a row tile of
// width f on the current card; -1 where none fits.
int staged_budget(int f) {
  int lo = -1, hi = 1 << 16;  // lo fits (or is -1), hi does not
  if (f > kMaxTileFeatures) return -1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    (staged_grid(staged_bytes(f, mid)) > 0 ? lo : hi) = mid;
  }
  return lo;
}

// The staged standard walk's grid over `groups` (host ints: the G + 1 first
// trees, then the G + 1 first records, each ending with its total), `bytes`
// of shared memory a block, `r_max` the largest group's records: two blocks
// an SM, where they fit and the rows give every block a tile; 0 where not.
long long staged_blocks(int n, int f, const int* groups, int n_groups, int* r_max, size_t* bytes) {
  if (f > kMaxTileFeatures || n_groups <= 0) return 0;
  *r_max = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int r = groups[n_groups + 1 + g + 1] - groups[n_groups + 1 + g];
    if (r > *r_max) *r_max = r;
  }
  *bytes = staged_bytes(f, *r_max);
  const long long blocks = staged_grid(*bytes);
  return ((long long)n + kStageThreads - 1) / kStageThreads < blocks ? 0 : blocks;
}

// Whether `groups` (as staged_blocks takes them) cut t trees and r records
// into groups of whole trees in order: each bound ascending, from 0 to the
// totals.
bool groups_valid(const int* groups, int n_groups, int t, int r) {
  if (n_groups < 0 || (n_groups > 0 && groups == nullptr)) return false;
  if (n_groups == 0) return true;
  const int* rec = groups + n_groups + 1;
  if (groups[0] != 0 || groups[n_groups] != t || rec[0] != 0 || rec[n_groups] > r) return false;
  for (int g = 0; g < n_groups; ++g)
    if (groups[g + 1] < groups[g] || rec[g + 1] < rec[g]) return false;
  return true;
}

// The launch of n rows of width f over records of k terms (k = 0: the
// standard walk's header-only records, cut into `groups`); `staged`,
// `r_max` and `bytes` are the staged walk's grid, largest group and shared
// memory where it is chosen.
Variant choose(int n, int f, int k, const int* groups, int n_groups, bool small, long long* staged, int* r_max,
               size_t* bytes) {
  if (small) return kTrees;
  if (k == 0 && (*staged = staged_blocks(n, f, groups, n_groups, r_max, bytes)) > 0) return kStaged;
  return f <= kMaxTileFeatures ? kTile : kGlobal;
}

// The staged walk over `groups`, kMaxGroups of them a launch, each launch
// after the first continuing the sums.
void launch_staged(const float* X, int n, int f, const Records& F, const int* groups, int n_groups, long long blocks,
                   int r_max, size_t bytes, float* out, cudaStream_t s) {
  const int* rec = groups + n_groups + 1;
  for (int g0 = 0; g0 < n_groups; g0 += kMaxGroups) {
    Groups G;
    G.count = n_groups - g0 < kMaxGroups ? n_groups - g0 : kMaxGroups;
    for (int g = 0; g <= G.count; ++g) {
      G.tree[g] = groups[g0 + g];
      G.record[g] = rec[g0 + g];
    }
    walk_staged_kernel<<<(int)blocks, kStageThreads, bytes, s>>>(X, n, f, F, G, r_max, g0 > 0, out);
  }
}

template <bool kMean, int kTerms>
void launch_terms(const float* X, int n, int f, const Records& F, Variant v, float* out, cudaStream_t s) {
  if (v == kTrees) {
    long long blocks = ((long long)n + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    path_trees_kernel<kMean, kTerms><<<(int)blocks, kThreads, 0, s>>>(X, n, f, F, out);
    return;
  }
  long long blocks = ((long long)n + kTileRows - 1) / kTileRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (v == kTile) {
    path_rows_kernel<kMean, kTerms, true>
        <<<(int)blocks, kThreads, (size_t)f * kTileRows * sizeof(float), s>>>(X, n, f, F, out);
  } else {
    path_rows_kernel<kMean, kTerms, false><<<(int)blocks, kThreads, 0, s>>>(X, n, f, F, out);
  }
}

template <bool kMean>
int launch(const void* X, int n, int f, const void* records, int r, const void* roots, int t, int k,
           int terms_per_chunk, int tree_parallel, const int* groups, int n_groups, void* out, void* stream,
           int* variant) {
  const int chunk_terms = k == 0 ? 0 : terms_per_chunk;
  if (n < 0 || f <= 0 || r < 0 || t <= 0 || k < 0 || (k > 0 && chunk_terms != 2 && chunk_terms != 3) ||
      (k > 0 && n_groups != 0) || !groups_valid(groups, n_groups, t, r))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Records F{static_cast<const int4*>(records), static_cast<const int*>(roots),
                  k == 0 ? 0 : (k + chunk_terms - 1) / chunk_terms, t, !kMean && k > 1 && k <= kPairedMaxK};
  const float* x = static_cast<const float*>(X);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long staged = 0;
  int r_max = 0;
  size_t bytes = 0;
  const Variant v = choose(n, f, k, groups, n_groups, tree_parallel != 0, &staged, &r_max, &bytes);
  switch (chunk_terms) {
    case 0:  // header-only records: the standard walk, a sum
      if constexpr (kMean) return (int)cudaErrorInvalidValue;
      else if (v == kStaged) launch_staged(x, n, f, F, groups, n_groups, staged, r_max, bytes, o, s);
      else launch_terms<false, 0>(x, n, f, F, v, o, s);
      break;
    case 3: launch_terms<kMean, 3>(x, n, f, F, v, o, s); break;
    case 2: launch_terms<kMean, 2>(x, n, f, F, v, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *variant = v;
  return (int)cudaGetLastError();
}

}  // namespace

// The three entries: X f32[n, f] row-major; records int32 [r, 4 * (1 +
// chunks)], 16-byte aligned, and roots int32 [t] as ops/ext_path.py builds
// them, with k terms at most per record (0: header-only standard records),
// terms_per_chunk (3 or 2) to a chunk; tree_parallel != 0 takes the
// small-batch kernel (one warp a row); groups, host int32 [2, n_groups +
// 1]: the first tree of each group of whole trees, then t, and its first
// record, then the last group's end, as ops/ext_path.py cuts a standard
// forest for the staged walk within staged_budget's records (n_groups 0:
// none, and always for an EIF); out f32[n]. Each launches on `stream`,
// writes the Variant it launched to *variant (nothing for n = 0, which
// launches nothing) and returns cudaGetLastError() of the launch.

// Sum over trees of each row's path length through a standard forest.
extern "C" int walk_sum(const void* X, int n, int f, const void* records, int r, const void* roots, int t,
                        int k, int terms_per_chunk, int tree_parallel, const int* groups, int n_groups, void* out,
                        void* stream, int* variant) {
  if (k != 0) return (int)cudaErrorInvalidValue;
  return launch<false>(X, n, f, records, r, roots, t, k, terms_per_chunk, tree_parallel, groups, n_groups, out,
                       stream, variant);
}

// Sum over trees of each row's path length through an EIF, in the walk
// kernel's dot order.
extern "C" int ext_walk_sum(const void* X, int n, int f, const void* records, int r, const void* roots, int t,
                            int k, int terms_per_chunk, int tree_parallel, const int* groups, int n_groups,
                            void* out, void* stream, int* variant) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  return launch<false>(X, n, f, records, r, roots, t, k, terms_per_chunk, tree_parallel, groups, n_groups, out,
                       stream, variant);
}

// Mean path length over trees (sum of pl / t in tree order), in the sparse
// kernel's dot order.
extern "C" int ext_sparse_mean(const void* X, int n, int f, const void* records, int r, const void* roots,
                               int t, int k, int terms_per_chunk, int tree_parallel, const int* groups,
                               int n_groups, void* out, void* stream, int* variant) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  return launch<true>(X, n, f, records, r, roots, t, k, terms_per_chunk, tree_parallel, groups, n_groups, out,
                      stream, variant);
}

// The Variant the three entries would launch for these arguments, in
// *variant; launches nothing.
extern "C" int path_variant(int n, int f, int r, int t, int k, int tree_parallel, const int* groups, int n_groups,
                            int* variant) {
  if (n <= 0 || f <= 0 || r < 0 || t <= 0 || k < 0 || (k > 0 && n_groups != 0) ||
      !groups_valid(groups, n_groups, t, r))
    return (int)cudaErrorInvalidValue;
  long long staged = 0;
  int r_max = 0;
  size_t bytes = 0;
  *variant = choose(n, f, k, groups, n_groups, tree_parallel != 0, &staged, &r_max, &bytes);
  return 0;
}

// The most records a group of whole trees may hold for the staged walk
// beside a row tile of width f on the current card, in *records (-1: the
// staged walk takes no rows of this width).
extern "C" int walk_staged_budget(int f, int* records) {
  if (f <= 0) return (int)cudaErrorInvalidValue;
  *records = staged_budget(f);
  return 0;
}
