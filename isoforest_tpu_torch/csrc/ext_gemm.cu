// Dense-hyperplane level walk of an extended (EIF) isolation forest, for
// Hopper (sm_90a): the hyperplane dots of a tile of rows against every
// internal slot of a tree, as a register-tiled float32 matrix product on the
// CUDA cores, then each row's walk over the go-right bits.
//
// Replaces isoforest_tpu/ops/pallas_traversal.py::_extended_pallas_dense
// (kernel body _extended_kernel_dense), which serves hyperplanes of k > 32
// coordinates from a dense [F] weight row per node. Same function: for
// every row and tree, every internal slot's test dot(x, w) >= offset, the
// row's path through the tree along the go-right bits, and the exit leaf's
// merged value (depth + c(numInstances)) as the tree's path length; the
// row's result accumulates `acc += pl / T` tree by tree, in tree order, with
// a true division (no --use_fast_math), as the TPU kernel's source does
// (pallas_traversal.py:269).
//
// The dot. XLA:CPU, the reference in interpret mode, computes the TPU
// kernel's X @ W as acc = fma(x[f], w[f], acc) from acc = 0 over the
// features in ascending order. Here every accumulator is that chain,
// pinned with __fmaf_rn: it sees feature 0, 1, 2, ... of its row and slot
// in turn, whatever the tiling. No tensor cores, no TF32, no library
// product: a tensor-core product neither keeps the order nor rounds as
// float32.
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
// the kernel takes the dense product for every row. Likewise the gather
// walk's x[0] * 0 term of a node with unused coordinates (kind bit 2) adds
// a zero on a finite x[0] and NaN on a non-finite one, so the bit is
// forced to "left" exactly where x[0] is NaN or +-inf.
// A row with NaN or +-inf among its first `width` features is flagged when
// its tile starts. Its dense dot equals the skipping form's only at nodes
// without absent coordinates (kind bit 4 clear): there the two chains are
// the same chain. At a node with absent coordinates its walk computes the
// node's dot again in the skipping form (the earlier kernel's arithmetic),
// for the h nodes on its path only. A forest whose every node uses every
// coordinate (the high-dim cell, k = F) never takes that form.
//
// What bounds it on this card: float32 FMAs. The dense algorithm evaluates
// every internal-capable slot of every tree for every row: 65,536 rows x
// 100 trees x 255 slots x 274 features = 4.6e11 FMAs in the high-dim cell,
// 13.7 ms at the card's 67 TFLOP/s. The earlier design (one thread per row,
// one dependent chain per slot, a warp-uniform weight load, a +0.0 test and
// a shared-memory read per FMA, 6 warps per SM) was bound by latency at 54x
// that. The function itself needs only the slots on each row's path, as the
// walk (ext_walk_sum in path_walk.cu) evaluates.
//
// What the design does about it:
//  * A block of 256 threads owns 128 rows and loops over the trees in order.
//    Per tree the dots are a [128 x width] by [width x 2^h - 1] product,
//    computed in column tiles of 64 * kGroups slots, each over width in
//    16-feature chunks.
//  * Each thread holds an 8 x (4 * kGroups) accumulator tile (4 + 4 rows,
//    kGroups groups of 4 slots 64 apart, split so the float4 shared-memory
//    reads of a quarter-warp hit all 32 banks): 32 * kGroups FMAs per 2 +
//    kGroups vector loads, so the FMA pipe sets the pace. The thread may
//    take the registers of one block per SM.
//  * The tile width follows the tree: 256 slots (kGroups = 4, 128 FMAs per
//    6 loads) where a tree has more than 128 internal-capable slots (h >= 8:
//    one tile a tree at h = 8), 128 slots (kGroups = 2) below, where a
//    256-slot tile would spend half its FMAs on padding.
//    tools/torch_port_kernel_paths.py times each width at every height,
//    192-slot tiles, two blocks' registers an SM, 8-feature chunks and a
//    2-stage ring against this build.
//  * The rows' chunk (transposed) and the weights' chunk stream into a
//    3-stage shared-memory ring with cp.async, one chunk ahead of the
//    next, across column tiles and trees, so loads overlap FMAs and the
//    walks. The weights are stored slot-minor, [T, width, M4] with M4 the
//    2^h - 1 slots rounded up to 4, so a chunk row is 16-byte copies; the
//    table (28 MB in the high-dim cell) stays in the 50 MB L2.
//  * A column tile's go-right bits go to per-row 32-bit words in shared
//    memory (atomicOr of 4-bit groups). After a tree's last tile, threads
//    0-127 each follow their row's bits h steps to the exit leaf.
//
// Height fence: kMaxHeight = 10, the dense strategy's one fence
// (DENSE_MAX_HEIGHT, set by the standard dense kernel's registers). Here a
// row's go-right bits take 2^h / 32 words: 128 rows' words are 16.5 KiB at
// h = 10, beside the 72.8 KiB ring of 256-slot tiles, in 89.5 KiB of
// dynamic shared memory; the words alone would double with each level
// above. The wrapper raises a ValueError above the fence; the walk kernel
// has none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows per block
constexpr int kBK = 16;   // features per chunk
constexpr int kStages = 3;
constexpr int kAStride = kBM + 4;  // a chunk row's stride: the transposed stores spread over banks
constexpr int kMaxHeight = 10;
constexpr int kMaxWords = (1 << kMaxHeight) / 32;
constexpr int kBitsStride = kMaxWords + 1;
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

// X: f32[n, f_count]; value, kind: [t_count, 2^(h+1) - 1]; weight:
// f32[t_count, width, m4]; out: f32[n]. kGroups: a thread's 4-slot groups,
// 64 slots apart, so a column tile is 64 * kGroups slots.
template <int kGroups>
__global__ void __launch_bounds__(kThreads, 1)
ext_gemm_kernel(const float* __restrict__ X, int n, int f_count, const float* __restrict__ value,
                const int* __restrict__ kind, const float* __restrict__ weight, int width, int m4,
                int t_count, int h, float* __restrict__ out) {
  constexpr int kBN = 64 * kGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
              // the skipping form: the node's own coordinates, then x[0] * 0
              const float* x = X + row * f_count;
              const float* w = weight + (long long)t * width * m4 + node;
              float dot = 0.f;
              for (int f = 0; f < width; ++f) {
                const float wv = __ldg(w + (long long)f * m4);
                if (__float_as_uint(wv) != 0u) dot = __fmaf_rn(x[f], wv, dot);
              }
              if (kd & kUnused) dot = __fmaf_rn(x[0], 0.f, dot);
              right = dot >= __ldg(t_val + node);
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

template <int kGroups>
int launch(const float* X, int n, int f, const float* value, const int* kind, const float* weight, int width,
           int m4, int t, int h, float* out, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<64 * kGroups>);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ext_gemm_kernel<kGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)n + kBM - 1) / kBM;
  ext_gemm_kernel<kGroups><<<(unsigned)blocks, kThreads, smem, stream>>>(X, n, f, value, kind, weight, width, m4,
                                                                         t, h, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Mean path length over trees, accumulated as sum of pl / t in tree order.
// X: f32[n, f] row-major; value (f32 merged plane) and kind (i32 bits: 1
// internal, 2 unused coordinates, 4 an absent coordinate below width)
// [t, 2^(h+1) - 1] in heap order; weight f32[t, width, m4], slot-minor,
// m4 = 2^h - 1 rounded up to 4 (+0.0 at absent coordinates and padding,
// -0.0 at present ones of zero weight), 16-byte aligned; width <= f; out:
// f32[n]. Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int ext_dense_mean(const void* X, int n, int f, const void* value, const void* kind,
                              const void* weight, int width, int t, int h, void* out, void* stream) {
  if (h < 0 || h > kMaxHeight || f <= 0 || t <= 0 || width <= 0 || width > f || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int m4 = ((1 << h) - 1 + 3) / 4 * 4;
  if (m4 > 0 && reinterpret_cast<uintptr_t>(weight) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const auto x = static_cast<const float*>(X);
  const auto v = static_cast<const float*>(value);
  const auto kd = static_cast<const int*>(kind);
  const auto w = static_cast<const float*>(weight);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // 256-slot column tiles above 128 slots, 128-slot tiles below
  return m4 > 128 ? launch<4>(x, n, f, v, kd, w, width, m4, t, h, o, s)
                  : launch<2>(x, n, f, v, kd, w, width, m4, t, h, o, s);
}
