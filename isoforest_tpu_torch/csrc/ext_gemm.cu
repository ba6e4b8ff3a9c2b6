// Dense-hyperplane level walk of an extended (EIF) isolation forest, for
// Hopper (sm_90a): the hyperplane dots of a tile of rows against the top
// levels of a tree as a register-tiled float32 product on the CUDA cores,
// then, below them, each row's dot at the one node its path reaches, level
// by level, to the exit leaf.
//
// Replaces isoforest_tpu/ops/pallas_traversal.py::_extended_pallas_dense
// (kernel body _extended_kernel_dense), which serves hyperplanes of k > 32
// coordinates from a dense [F] weight row per node. Same function: for
// every row and tree, the test dot(x, w) >= offset at each internal node on
// the row's path, the path along those go-right bits, and the exit leaf's
// merged value (depth + c(numInstances)) as the tree's path length; the
// row's result accumulates `acc += pl / T` tree by tree, in tree order, with
// a true division (no --use_fast_math), as the TPU kernel's source does
// (pallas_traversal.py:269). The TPU kernel evaluates every internal slot
// and reads the bits on the path; only those bits reach the result, so
// evaluating the path's nodes alone gives the same result bit for bit.
//
// The dot. XLA:CPU, the reference in interpret mode, computes the TPU
// kernel's X @ W as acc = fma(x[f], w[f], acc) from acc = 0 over the
// features in ascending order. Here every dot is that chain, pinned with
// __fmaf_rn: it sees feature 0, 1, 2, ... of its row and node in turn, in
// the product's accumulators and in the path walk's alike. No tensor cores,
// no TF32, no library product: a tensor-core product neither keeps the
// order nor rounds as float32.
//
// Finite rows may FMA over absent coordinates. The table stores +0.0 for a
// coordinate the node does not use (absent) and -0.0 for one it uses with a
// merged weight of 0. The reference's own chain (and the plain version's
// skipping form) leaves absent coordinates out. On a row whose features are
// all finite, x * (+0.0) is a zero, and fma(x, +0.0, acc) returns acc
// unchanged but for the sign of a zero acc. A zero's sign never reaches a
// later nonzero term's sum, and `dot >= offset` is the same for +0 and -0.
// So on such rows the chain over every coordinate of the dense row gives
// the same go-right bit as the chain over the node's own coordinates, and
// the kernel takes it for every row. Likewise the gather walk's x[0] * 0
// term of a node with unused coordinates (kind bit 2) adds a zero on a
// finite x[0] and NaN on a non-finite one, so the bit is forced to "left"
// exactly where x[0] is NaN or +-inf.
// A row with NaN or +-inf among its first `width` features is flagged when
// its tile starts. Its dense dot equals the skipping form's only at nodes
// without absent coordinates (kind bit 4 clear): there the two chains are
// the same chain. At a node with absent coordinates its walk computes the
// node's dot again in the skipping form, for the nodes on its path only. A
// forest whose every node uses every coordinate (the high-dim cell, k = F)
// never takes that form.
//
// Two forms, one per launch, chosen by the host from the tree height and
// the table width (ops/ext_dense.py::dense_top_levels):
//  * The dense-top form (top = L, 2 <= L <= 5, L < h). A block of 256
//    threads owns 128 rows, held in shared memory for the whole launch
//    (feature-major, 152 KB at width 274), so X is read from device memory
//    once a block. For each tile of 64 / 2^L trees the block computes the
//    slots of levels 0 .. L-1, heap slots 0 .. 2^L - 2, the first columns
//    of the slot-minor table: a [128 x width] by [width x 64] product, 2^L
//    columns a tree, each thread an 8 x 4 accumulator tile (32 FMAs per 3
//    float4 shared-memory reads), the weights' 16-feature chunks streaming
//    into a 3-stage cp.async ring across tiles. Every 16 trees (kWalkTrees)
//    each (row, tree) follows those bits to level L and, for levels L ..
//    h-1, computes the dot of the one node it stands on: x[f] from shared
//    memory, the weights from a node-major copy of the table, a node's row
//    in 16-byte loads. A thread walks its row through 8 trees at once
//    (kWalkChains), so each shared-memory read of x[f] serves 8 FMAs and 8
//    independent loads are in flight.
//  * The fully dense form (top = h: trees of height <= 2, and tables too
//    wide for the resident tile, width > kPathMaxWidth). Every
//    internal-capable slot of a tree in column tiles of 64 * kGroups
//    slots, the rows' and the weights' chunks both streaming through the
//    ring; the go-right bits to per-row 32-bit words; threads 0-127 then
//    follow their row's bits h steps.
//
// What bounds it on this card. The function needs a row's dot at the
// internal nodes on its path, 8 a tree at most in the high-dim cell (h =
// 8), where the fully dense form computed all 255 slots: 65,536 rows x 100
// trees x 255 x 274 = 4.6e11 FMAs, 13.7 ms at the card's 67 TFLOP/s, 27 ms
// as measured. In the dense-top form the product's FMAs fall to 2^L / 256
// of that (0.85 ms at L = 3, at the measured rate), and the walk does
// about h - L dots a (row, tree). The walk's weights are shared only by
// rows that stand on the same node, so it is bound by its loads: each 4
// FMAs of a chain take a 16-byte load through L1, and a warp's load
// touches one line for each distinct node among its 32 rows (3.5 to 9.3
// nodes at levels 3 to 7 on the rows of the benchmark's arrhythmia-eif
// configuration, up to 32 on uniform rows). The lines come from the 50 MB
// L2, which holds what the form reads: the node-major table (28 MB at h =
// 8) and the slot-minor table's top columns. What the design does about
// it: one x[f] read serves 8 chains; a 16-byte load serves 4 FMAs, a
// quarter of the load instructions of per-feature gathers from the
// slot-minor table, and a node's weights are whole lines, where a deep
// level's slot-minor slice spans 4 lines a feature; and 16 unrolled loads
// a thread are in flight. tools/torch_port_kernel_paths.py times every L
// at each height and on that configuration's own forest, the fully dense
// form beside them, and the walk's chains, unrolling and rows a block.
//
// Height fence: kMaxHeight = 10, the dense strategy's one fence
// (DENSE_MAX_HEIGHT, set by the standard dense kernel's registers). In the
// fully dense form a row's go-right bits take 2^h / 32 words: 128 rows'
// words are 16.5 KiB at h = 10, beside the 72.8 KiB ring of 256-slot tiles,
// in 89.5 KiB of dynamic shared memory; the words alone would double with
// each level above. The wrapper raises a ValueError above the fence; the
// walk kernel has none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows per block of the fully dense form
constexpr int kBK = 16;   // features per chunk
constexpr int kStages = 3;
constexpr int kAStride = kBM + 4;  // a chunk row's stride: the transposed stores spread over banks
constexpr int kMaxHeight = 10;
constexpr int kMaxWords = (1 << kMaxHeight) / 32;
constexpr int kBitsStride = kMaxWords + 1;
// the dense-top form
constexpr int kPathRows = 128;                // rows per block, resident in shared memory
constexpr int kPathStride = kPathRows + 4;    // a feature's stride in the resident tile
constexpr int kTopColumns = 64;               // the product's column tile: 64 / 2^L trees of 2^L slots
constexpr int kMinTop = 2, kMaxTop = 5;       // dense-top levels: 16 to 2 trees a tile, a word of bits each
constexpr int kPathMaxWidth = 384;            // widest table whose resident tile fits (ops/ext_dense.py)
constexpr int kLanes = kThreads / kPathRows;  // threads a row in the path walk
constexpr int kWalkChains = 8;                // trees a thread walks at once
constexpr int kWalkTrees = kLanes * kWalkChains;  // trees a block walks at once
constexpr int kSmemOptin = 232448;            // dynamic shared memory a block may take on sm_90
// bits of the kind table
constexpr int kInternal = 1;  // an internal node
constexpr int kUnused = 2;    // has unused coordinates: the gather walk's x[0] * 0 term
constexpr int kAbsent = 4;    // some coordinate below width has no weight (+0.0)

// kBN: slots per column tile
template <int kBN>
struct Smem {
  float a[kStages][kBK][kAStride];  // rows' chunk, feature-major
  float b[kStages][kBK][kBN];       // weights' chunk, slot-minor
  uint32_t bits[kBM][kBitsStride];  // go-right bits of each row, 32 slots a word
  unsigned char nonfinite[kBM];     // NaN or +-inf among the row's first `width` features
  unsigned char x0_nonfinite[kBM];  // x[0] is NaN or +-inf
};

// The dense-top form's fixed part; the resident rows' tile follows it,
// float[width rounded up to kBK][kPathStride], feature-major.
template <int kTop>
struct TopSmem {
  static constexpr int kG = kTopColumns >> kTop;  // trees a column tile
  float b[kStages][kBK][kTopColumns];             // weights' chunk: each tree's first 2^kTop slots
  uint32_t bits[kWalkTrees][kPathRows];           // the top's go-right bits of each tree of a walk and row
  float leaf[kWalkTrees][kPathRows];              // each tree's path length of each row
  unsigned char nonfinite[kPathRows];
  unsigned char x0_nonfinite[kPathRows];
};

constexpr long long top_smem_bytes(long long fixed, int width) {
  return fixed + (long long)(width + kBK - 1) / kBK * kBK * kPathStride * sizeof(float);
}
static_assert(top_smem_bytes(sizeof(TopSmem<kMinTop>), kPathMaxWidth) <= kSmemOptin,
              "the resident tile of the widest table fits");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The skipping form of one node's dot: the node's own coordinates (a +0.0
// weight is absent and skipped), then x[0] * 0 where the node has unused
// coordinates. x: the row's feature 0, features `stride` floats apart; w:
// the node's weight at feature 0 in the slot-minor table.
__device__ __forceinline__ float skipping_dot(const float* x, int stride, const float* __restrict__ w, int m4,
                                              int width, int kd) {
  float dot = 0.f;
  for (int f = 0; f < width; ++f) {
    const float wv = __ldg(w + (long long)f * m4);
    if (__float_as_uint(wv) != 0u) dot = __fmaf_rn(x[f * stride], wv, dot);
  }
  if (kd & kUnused) dot = __fmaf_rn(x[0], 0.f, dot);
  return dot;
}

// The fully dense form. kGroups: a thread's 4-slot groups, 64 slots apart,
// so a column tile is 64 * kGroups slots.
template <int kGroups>
__device__ __forceinline__ void dense_walk(const float* __restrict__ X, int n, int f_count,
                                           const float* __restrict__ value, const int* __restrict__ kind,
                                           const float* __restrict__ weight, int width, int m4, int t_count, int h,
                                           float* __restrict__ out, unsigned char* smem_raw) {
  constexpr int kBN = 64 * kGroups;
  Smem<kBN>& sm = *reinterpret_cast<Smem<kBN>*>(smem_raw);
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kBM;
  const long long m = (1LL << (h + 1)) - 1;  // heap slots per tree
  const int m_int = (1 << h) - 1;            // internal-capable slots
  const int words = (m_int + 31) / 32;
  const float t_real = (float)t_count;
  float acc_row = 0.f;  // threads 0-127: the mean of row row0 + tid

  if (tid < kBM) {
    const long long r = row0 + tid;
    sm.nonfinite[tid] = 0;
    sm.x0_nonfinite[tid] = r < n && !isfinite(X[r * f_count]);
    for (int w = 0; w < kBitsStride; ++w) sm.bits[tid][w] = 0u;
  }
  __syncthreads();
  for (long long e = tid; e < (long long)kBM * width; e += kThreads) {
    const int r = (int)(e / width);
    const int f = (int)(e - (long long)r * width);
    if (row0 + r < n && !isfinite(X[(row0 + r) * f_count + f])) sm.nonfinite[r] = 1;
  }
  __syncthreads();

  if (m_int == 0) {  // height 0: every tree is its root leaf
    if (tid < kBM && row0 + tid < n) {
      for (int t = 0; t < t_count; ++t) acc_row += __ldg(value + t * m) / t_real;
      out[row0 + tid] = acc_row;
    }
    return;
  }

  const int kc_n = (width + kBK - 1) / kBK;  // feature chunks per column tile
  const int nt_n = (m4 + kBN - 1) / kBN;     // column tiles per tree
  const int ty = tid / 16, tx = tid % 16;

  // Copy chunk (t, nt, kc) into ring stage `st`; zeros past n rows, width
  // features and m4 slots.
  auto load = [&](int t, int nt, int kc, int st) {
    const int f0 = kc * kBK, n0 = nt * kBN;
#pragma unroll
    for (int q = 0; q < kBM * kBK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const bool ok = row0 + r < n && f0 + kk < width;
      cp_async4(&sm.a[st][kk][r], ok ? X + (row0 + r) * f_count + f0 + kk : X, ok);
    }
#pragma unroll
    for (int q = 0; q < kBK * kBN / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e / (kBN / 4), c = e % (kBN / 4) * 4;
      const bool ok = f0 + kk < width && n0 + c < m4;
      cp_async16(&sm.b[st][kk][c], ok ? weight + ((long long)t * width + f0 + kk) * m4 + n0 + c : weight, ok);
    }
  };
  auto advance = [&](int& t, int& nt, int& kc) {
    if (++kc == kc_n) {
      kc = 0;
      if (++nt == nt_n) {
        nt = 0;
        ++t;
      }
    }
  };

  int lt = 0, lnt = 0, lkc = 0, lst = 0;  // the next chunk to load, and its stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (lt < t_count) {
      load(lt, lnt, lkc, lst);
      advance(lt, lnt, lkc);
      lst = (lst + 1) % kStages;
    }
    cp_async_commit();
  }

  float acc[8][4 * kGroups];
  int t = 0, nt = 0, kc = 0, st = 0;  // the chunk to compute, and its stage
  while (t < t_count) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk (t, nt, kc) has landed; the stage it reuses is free
    if (lt < t_count) {
      load(lt, lnt, lkc, lst);
      advance(lt, lnt, lkc);
      lst = (lst + 1) % kStages;
    }
    cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kGroups; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[st][kk][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 bg = *reinterpret_cast<const float4*>(&sm.b[st][kk][64 * g + tx * 4]);
        b[4 * g] = bg.x, b[4 * g + 1] = bg.y, b[4 * g + 2] = bg.z, b[4 * g + 3] = bg.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kGroups; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }

    if (kc == kc_n - 1) {
      // the column tile's go-right bits; NaN compares false and goes left
      const int* t_kind = kind + t * m;
      const float* t_val = value + t * m;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int s0 = nt * kBN + g * 64 + tx * 4;  // this thread's 4 slots, within one word
        float v[4];
        bool unused[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool inside = s0 + j < m_int;
          v[j] = inside ? __ldg(t_val + s0 + j) : 0.f;
          unused[j] = inside && (__ldg(t_kind + s0 + j) & kUnused);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
          const bool x0_nf = sm.x0_nonfinite[r];
          uint32_t nibble = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            nibble |= (uint32_t)(acc[i][g * 4 + j] >= v[j] && !(unused[j] && x0_nf)) << j;
          }
          if (nibble) atomicOr(&sm.bits[r][s0 >> 5], nibble << (s0 & 31));
        }
      }
      if (nt == nt_n - 1) {
        __syncthreads();  // every tile's bits are in
        if (tid < kBM) {
          const long long row = row0 + tid;
          int node = 0;
          for (int level = 0; level < h; ++level) {  // node < m_int at every level above h
            const int kd = __ldg(t_kind + node);
            if (!(kd & kInternal)) break;
            int right;
            if ((kd & kAbsent) && sm.nonfinite[tid]) {
              const float* w = weight + (long long)t * width * m4 + node;
              right = skipping_dot(X + row * f_count, 1, w, m4, width, kd) >= __ldg(t_val + node);
            } else {
              right = (int)((sm.bits[tid][node >> 5] >> (node & 31)) & 1u);
            }
            node = 2 * node + 1 + right;
          }
          acc_row += __ldg(t_val + node) / t_real;
          for (int w = 0; w < words; ++w) sm.bits[tid][w] = 0u;  // read before the next tree's bits land
        }
      }
    }
    advance(t, nt, kc);
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();
  if (tid < kBM && row0 + tid < n) out[row0 + tid] = acc_row;
}

// The dense-top form: levels 0 .. kTop - 1 of each tree as a product over
// the resident rows, then levels kTop .. h - 1 one node a (row, tree).
template <int kTop>
__device__ __forceinline__ void top_path_walk(const float* __restrict__ X, int n, int f_count,
                                              const float* __restrict__ value, const int* __restrict__ kind,
                                              const float* __restrict__ weight,
                                              const float* __restrict__ node_weight, int width, int m4,
                                              int t_count, int h, float* __restrict__ out, unsigned char* smem_raw) {
  using S = TopSmem<kTop>;
  constexpr int kG = S::kG;
  constexpr int kC = 1 << kTop;              // columns a tree: its 2^kTop - 1 top slots, then one more
  constexpr int kRowQuads = kPathRows / 64;  // a thread's 4-row groups in the product
  static_assert(sizeof(S) % 16 == 0 && kC >= 4 && kWalkTrees % kG == 0, "16-byte copies; whole tiles a walk");
  S& sm = *reinterpret_cast<S*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + sizeof(S));
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kPathRows;
  const int m = (1 << (h + 1)) - 1;  // heap slots per tree
  const int m_int = (1 << h) - 1;    // internal-capable slots, the node-major table's rows a tree
  const int w4 = (width + 3) / 4 * 4;  // a node-major row's floats
  const float t_real = (float)t_count;
  const int kc_n = (width + kBK - 1) / kBK;
  const int wpad = kc_n * kBK;  // >= w4: the tile's rows past width are zeros
  const int groups = (t_count + kG - 1) / kG;

  // the rows' tile, once; zeros past n rows and width features
  for (int e = tid; e < kPathRows * wpad; e += kThreads) {
    const int r = e / wpad, f = e - r * wpad;
    const bool ok = row0 + r < n && f < width;
    cp_async4(xs + f * kPathStride + r, ok ? X + (row0 + r) * f_count + f : X, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kPathRows) {
    bool nf = false;
    for (int f = 0; f < width; ++f) nf |= !isfinite(xs[f * kPathStride + tid]);
    sm.nonfinite[tid] = nf;
    sm.x0_nonfinite[tid] = !isfinite(xs[tid]);
#pragma unroll
    for (int g = 0; g < kWalkTrees; ++g) sm.bits[g][tid] = 0u;
  }  // read after the first chunk's barrier

  const int ty = tid / 16, tx = tid % 16;
  // Copy the weights of chunk (tile gt, features kc) into ring stage `st`:
  // column c is slot c % kC of tree gt * kG + c / kC; zeros past width and
  // t_count.
  auto load = [&](int gt, int kc, int st) {
    for (int e = tid; e < kBK * kTopColumns / 4; e += kThreads) {
      const int kk = e / (kTopColumns / 4), c = e % (kTopColumns / 4) * 4;
      const int f = kc * kBK + kk, t = gt * kG + c / kC;
      const bool ok = f < width && t < t_count;
      cp_async16(&sm.b[st][kk][c], ok ? weight + ((long long)t * width + f) * m4 + c % kC : weight, ok);
    }
  };
  auto advance = [&](int& gt, int& kc) {
    if (++kc == kc_n) {
      kc = 0;
      ++gt;
    }
  };

  int lg = 0, lkc = 0, lst = 0;  // the next chunk to load, and its stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (lg < groups) {
      load(lg, lkc, lst);
      advance(lg, lkc);
      lst = (lst + 1) % kStages;
    }
    cp_async_commit();
  }

  const int wr = tid % kPathRows, lane = tid / kPathRows;  // the walk's row, and its lane
  const float* xr = xs + wr;                               // the row's feature f at xr[f * kPathStride]
  float acc_row = 0.f;                                     // threads 0 .. kPathRows - 1: row row0 + tid
  float acc[4 * kRowQuads][4];
  int gt = 0, kc = 0, st = 0;  // the chunk to compute, and its stage
  while (gt < groups) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk (gt, kc) has landed; the stage it reuses is free
    if (lg < groups) {
      load(lg, lkc, lst);
      advance(lg, lkc);
      lst = (lst + 1) % kStages;
    }
    cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 4 * kRowQuads; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float* xf = xs + (kc * kBK + kk) * kPathStride;
      float a[4 * kRowQuads];
#pragma unroll
      for (int q = 0; q < kRowQuads; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xf + 64 * q + ty * 4);
        a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
      }
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[st][kk][tx * 4]);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4 * kRowQuads; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }

    const int t0 = gt * kG / kWalkTrees * kWalkTrees;  // the first tree of the walk this tile belongs to
    if (kc == kc_n - 1) {  // the top's go-right bits; NaN compares false and goes left
      const int g = gt * kG - t0 + tx * 4 / kC, s0 = tx * 4 % kC;  // this thread's tree in the walk, its 4 slots
      const int t = t0 + g;
      float v[4];
      bool inside[4], unused[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        inside[j] = t < t_count && s0 + j < kC - 1;
        v[j] = inside[j] ? __ldg(value + t * m + s0 + j) : 0.f;
        unused[j] = inside[j] && (__ldg(kind + t * m + s0 + j) & kUnused);
      }
#pragma unroll
      for (int i = 0; i < 4 * kRowQuads; ++i) {
        const int r = (i / 4) * 64 + ty * 4 + (i & 3);
        const bool x0_nf_r = sm.x0_nonfinite[r];
        uint32_t nibble = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          nibble |= (uint32_t)(inside[j] && acc[i][j] >= v[j] && !(unused[j] && x0_nf_r)) << j;
        }
        if (nibble) atomicOr(&sm.bits[g][r], nibble << s0);
      }
    }
    if (kc == kc_n - 1 && ((gt + 1) * kG % kWalkTrees == 0 || gt == groups - 1)) {
      __syncthreads();  // the walk's top bits are in

      // Each (row, tree) of the walk to its exit leaf, kWalkChains trees a
      // thread at once: the top along the bits (the skipping form where the
      // row is not finite and the node has absent coordinates), then each
      // level's node on its own.
      const bool nf = sm.nonfinite[wr], x0_nf = sm.x0_nonfinite[wr];
      int node[kWalkChains], tree[kWalkChains];
      bool valid[kWalkChains], live[kWalkChains];
#pragma unroll
      for (int c = 0; c < kWalkChains; ++c) {
        const int g = lane + kLanes * c;
        valid[c] = t0 + g < t_count;
        tree[c] = valid[c] ? t0 + g : 0;
        const uint32_t bits = sm.bits[g][wr];
        sm.bits[g][wr] = 0u;  // read; the next walk's bits land after two barriers
        int nd = 0;
        bool lv = valid[c];
        for (int level = 0; level < kTop && lv; ++level) {
          const int kd = __ldg(kind + tree[c] * m + nd);
          if (!(kd & kInternal)) {
            lv = false;
            break;
          }
          int right;
          if ((kd & kAbsent) && nf) {
            const float* w = weight + (long long)tree[c] * width * m4 + nd;
            right = skipping_dot(xr, kPathStride, w, m4, width, kd) >= __ldg(value + tree[c] * m + nd);
          } else {
            right = (int)((bits >> nd) & 1u);
          }
          nd = 2 * nd + 1 + right;
        }
        node[c] = nd;
        live[c] = lv;
      }
      for (int level = kTop; level < h; ++level) {
        int kd[kWalkChains];
        bool any = false;
#pragma unroll
        for (int c = 0; c < kWalkChains; ++c) {
          kd[c] = live[c] ? __ldg(kind + tree[c] * m + node[c]) : 0;
          live[c] = kd[c] & kInternal;
          any |= live[c];
        }
        if (!any) break;
        const float* w[kWalkChains];
        float dot[kWalkChains];
#pragma unroll
        for (int c = 0; c < kWalkChains; ++c) {  // a chain at a leaf reads slot 0's weights, and is not used
          w[c] = node_weight + ((long long)tree[c] * m_int + (live[c] ? node[c] : 0)) * w4;
          dot[c] = 0.f;
        }
        // past width both the row and the weights are zeros: fma(0, 0, dot)
        // changes at most the sign of a zero dot
#pragma unroll 2
        for (int f = 0; f < w4; f += 4) {
          const float x[4] = {xr[f * kPathStride], xr[(f + 1) * kPathStride], xr[(f + 2) * kPathStride],
                              xr[(f + 3) * kPathStride]};
#pragma unroll
          for (int c = 0; c < kWalkChains; ++c) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(w[c] + f));
            dot[c] = __fmaf_rn(x[0], wv.x, dot[c]);
            dot[c] = __fmaf_rn(x[1], wv.y, dot[c]);
            dot[c] = __fmaf_rn(x[2], wv.z, dot[c]);
            dot[c] = __fmaf_rn(x[3], wv.w, dot[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kWalkChains; ++c) {
          if (!live[c]) continue;
          const float v = __ldg(value + tree[c] * m + node[c]);
          int right;
          if ((kd[c] & kAbsent) && nf) {
            const float* ws = weight + (long long)tree[c] * width * m4 + node[c];
            right = skipping_dot(xr, kPathStride, ws, m4, width, kd[c]) >= v;
          } else {
            right = dot[c] >= v && !((kd[c] & kUnused) && x0_nf);
          }
          node[c] = 2 * node[c] + 1 + right;
        }
      }
#pragma unroll
      for (int c = 0; c < kWalkChains; ++c) {
        if (valid[c]) sm.leaf[lane + kLanes * c][wr] = __ldg(value + tree[c] * m + node[c]);
      }
      __syncthreads();  // every tree's path length is in
      if (tid < kPathRows) {
        for (int g = 0; g < kWalkTrees && t0 + g < t_count; ++g) acc_row += sm.leaf[g][tid] / t_real;
      }
    }
    advance(gt, kc);
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();
  if (tid < kPathRows && row0 + tid < n) out[row0 + tid] = acc_row;
}

// X: f32[n, f_count]; value, kind: [t_count, 2^(h+1) - 1]; weight:
// f32[t_count, width, m4]; out: f32[n]. kTop = 0: the fully dense form, in
// column tiles of 64 * kGroups slots; else the dense-top form with kTop
// levels dense (kGroups 1).
template <int kGroups, int kTop>
__global__ void __launch_bounds__(kThreads, 1)
ext_gemm_kernel(const float* __restrict__ X, int n, int f_count, const float* __restrict__ value,
                const int* __restrict__ kind, const float* __restrict__ weight,
                const float* __restrict__ node_weight, int width, int m4, int t_count, int h,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kTop == 0) {
    dense_walk<kGroups>(X, n, f_count, value, kind, weight, width, m4, t_count, h, out, smem_raw);
  } else {
    top_path_walk<kTop>(X, n, f_count, value, kind, weight, node_weight, width, m4, t_count, h, out, smem_raw);
  }
}

template <int kGroups, int kTop>
int launch(const float* X, int n, int f, const float* value, const int* kind, const float* weight,
           const float* node_weight, int width, int m4, int t, int h, float* out, cudaStream_t stream) {
  long long smem;
  if constexpr (kTop == 0) {
    smem = sizeof(Smem<64 * kGroups>);
  } else {
    smem = top_smem_bytes(sizeof(TopSmem<kTop>), width);
  }
  const int rows = kTop == 0 ? kBM : kPathRows;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ext_gemm_kernel<kGroups, kTop>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)n + rows - 1) / rows;
  ext_gemm_kernel<kGroups, kTop><<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      X, n, f, value, kind, weight, node_weight, width, m4, t, h, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Mean path length over trees, accumulated as sum of pl / t in tree order.
// X: f32[n, f] row-major; value (f32 merged plane) and kind (i32 bits: 1
// internal, 2 unused coordinates, 4 an absent coordinate below width)
// [t, 2^(h+1) - 1] in heap order; weight f32[t, width, m4], slot-minor,
// m4 = 2^h - 1 rounded up to 4 (+0.0 at absent coordinates and padding,
// -0.0 at present ones of zero weight), 16-byte aligned; node_weight
// f32[t, 2^h - 1, w4], the same weights node-major, w4 = width rounded up
// to 4 (+0.0 past width), 16-byte aligned, read by the dense-top form
// alone; width <= f; top: the levels computed as a product, h for the fully
// dense form, else kMinTop .. kMaxTop below h with width <= kPathMaxWidth;
// out: f32[n]. Launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int ext_dense_mean(const void* X, int n, int f, const void* value, const void* kind,
                              const void* weight, const void* node_weight, int width, int t, int h, int top,
                              void* out, void* stream) {
  if (h < 0 || h > kMaxHeight || f <= 0 || t <= 0 || width <= 0 || width > f || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (top != h && (top < kMinTop || top > kMaxTop || top >= h || width > kPathMaxWidth)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m4 = ((1 << h) - 1 + 3) / 4 * 4;
  if (m4 > 0 && (reinterpret_cast<uintptr_t>(weight) % 16 != 0 || reinterpret_cast<uintptr_t>(node_weight) % 16 != 0)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n == 0) return 0;
  const auto x = static_cast<const float*>(X);
  const auto v = static_cast<const float*>(value);
  const auto kd = static_cast<const int*>(kind);
  const auto w = static_cast<const float*>(weight);
  const auto nw = static_cast<const float*>(node_weight);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (top == h ? 0 : top) {
    case 2: return launch<1, 2>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s);
    case 3: return launch<1, 3>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s);
    case 4: return launch<1, 4>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s);
    case 5: return launch<1, 5>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s);
    default:
      // 256-slot column tiles above 128 slots, 128-slot tiles below
      return m4 > 128 ? launch<4, 0>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s)
                      : launch<2, 0>(x, n, f, v, kd, w, nw, width, m4, t, h, o, s);
  }
}
