// Gather-free dense level walk of a standard isolation forest, for Hopper
// (sm_90a): every internal-capable slot's go-right bit of a row comes from
// one warp vote, then the row follows its bits to the exit leaf.
//
// Replaces the TPU kernel isoforest_tpu/ops/pallas_traversal.py::
// _standard_pallas (kernel body _standard_kernel). Same function and the
// same dense nature: for every row and tree, EVERY internal-capable slot's
// comparison x[feature[m]] >= value[m] is evaluated, the row's path from
// the root follows the go-right bits, and the exit leaf's merged value
// (depth + c(numInstances)) is the tree's path length. The row's result
// accumulates `acc += pl / T` tree by tree, in tree order, with a true
// division (no --use_fast_math), as the source of _standard_kernel does
// (pallas_traversal.py:190). A compare is exact, so no float32 path can
// round otherwise: NaN compares false and goes left, +-inf compare as
// numbers, on every row width.
//
// What bounds it on this card: issued instructions. X and the output are
// 28 MB at the 1M-row x 100-tree headline (about 8 us of HBM time); the
// dense algorithm makes 2.55e10 compares there. The earlier design (one
// thread per row, all 2^(h+1) - 1 heap slots including the 2^h leaf-level
// ones, a 12-way select per slot whatever the width) issued about 511
// warp-instructions per (row, tree), 50 ms of the card's ~1e12
// warp-instructions per second. The function itself needs only the
// compares on each row's path, as the walk (walk_sum in path_walk.cu) does.
//
// What the design does about it:
//  * Lanes over slots. Per tree, lane l of a warp holds, for each 32-slot
//    word w, the offset of x[feature] of slot 32w + l in the warp's row
//    tile and the slot's threshold. One shared-memory read, one compare and
//    one __ballot_sync then give 32 go-right bits of one row: about 4
//    warp-instructions per word, 8 words per (row, tree) at h = 8. Only the
//    2^h - 1 internal-capable slots are evaluated; the leaf level has no
//    go-right bit, and its exit value is read after the path is known.
//  * A warp owns 32 rows; lane j keeps row j's words, stores them in
//    shared memory, and follows them h steps to the exit leaf.
//  * Rows of any width go through one shared-memory row tile per warp,
//    feature-major with a stride of 33 (x_s[f * 33 + j]): lanes that read
//    distinct features hit distinct banks, and a feature shared by several
//    slots is a broadcast. Rows of more than kMaxChunk features pass through
//    the tile in chunks of kMaxChunk, a slot's lane taking part in the
//    chunk that holds its feature; a slot of another chunk, a leaf or a
//    hole compares against NaN and votes 0.
//  * The block's 4 warps walk the same tree at a time. Each tree's feature
//    and value tables are staged in shared memory with cp.async while the
//    tree before runs (double buffer, one __syncthreads a tree).
//    tools/torch_port_kernel_paths.py times 8 warps a block, and the 32-row
//    loop bounded by the warp's rows and unrolled 8 times, against this
//    build.
//
// Height fence: kMaxHeight = 10, kept from the earlier design. At h = 10 a
// lane holds 32 words' tile offset, threshold and bits (96 of its 193
// registers); at h = 11 those double and pass the 255 a thread may have. The wrapper
// raises a ValueError above it; the walk kernel has no fence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeight = 10;
constexpr int kMaxChunk = 64;   // features in a warp's row tile at once
constexpr int kTileStride = 33; // x_s[f * 33 + j]: distinct features, distinct banks

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <int H>
struct Heap {
  static constexpr int kSlots = (1 << (H + 1)) - 1;
  static constexpr int kInternal = (1 << H) - 1;  // internal-capable slots
  static constexpr int kWords = (kInternal + 31) / 32;
};

// Shared-memory bytes of one block: the warps' row tiles, two trees'
// tables, the warps' bit words.
template <int H>
size_t smem_bytes(int chunk) {
  using P = Heap<H>;
  return 4 * ((size_t)kWarps * chunk * kTileStride + 2 * P::kInternal + 2 * P::kSlots +
              (size_t)kWarps * P::kWords * 32);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ X, int n, int f_count, const int* __restrict__ feat,
             const float* __restrict__ val, int t_count, int chunk, float* __restrict__ out) {
  using P = Heap<H>;
  constexpr int kWords = P::kWords;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* x_s = smem + warp * chunk * kTileStride;
  int* s_feat = reinterpret_cast<int*>(smem + kWarps * chunk * kTileStride);  // [2][kInternal]
  float* s_val = reinterpret_cast<float*>(s_feat + 2 * P::kInternal);         // [2][kSlots]
  uint32_t* bits = reinterpret_cast<uint32_t*>(s_val + 2 * P::kSlots) + warp * kWords * 32;

  const long long row0 = (long long)blockIdx.x * kThreads + warp * 32;  // the warp's first row
  const int rows = row0 < n ? (int)min(32LL, (long long)n - row0) : 0;  // its rows below n
  const int chunks = (f_count + chunk - 1) / chunk;
  const float t_real = (float)t_count;
  const float nan = __int_as_float(0x7fc00000);

  // features f0 .. f0 + cw - 1 of the warp's rows into its tile (zeros past n)
  auto stage = [&](int f0, int cw) {
    __syncwarp();
    for (int e = lane; e < 32 * cw; e += 32) {
      const int j = e / cw, f = e - j * cw;
      x_s[f * kTileStride + j] = j < rows ? X[(row0 + j) * f_count + f0 + f] : 0.f;
    }
    __syncwarp();
  };
  auto load_tree = [&](int t, int buf) {
    const long long base = (long long)t * P::kSlots;
    for (int i = threadIdx.x; i < P::kInternal; i += kThreads) {
      cp_async4(s_feat + buf * P::kInternal + i, feat + base + i);
    }
    for (int i = threadIdx.x; i < P::kSlots; i += kThreads) cp_async4(s_val + buf * P::kSlots + i, val + base + i);
    cp_async_commit();
  };

  if (chunks == 1 && rows > 0) stage(0, f_count);
  load_tree(0, 0);
  float acc = 0.f;
  for (int t = 0; t < t_count; ++t) {
    const int buf = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tree t has landed; every warp is done with tree t - 1's buffer
    if (t + 1 < t_count) load_tree(t + 1, buf ^ 1);
    if (rows == 0) continue;
    const int* tf = s_feat + buf * P::kInternal;
    const float* tv = s_val + buf * P::kSlots;
    if constexpr (kWords > 0) {
      uint32_t own[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) own[w] = 0u;
      for (int c = 0; c < chunks; ++c) {
        const int f0 = c * chunk, cw = min(chunk, f_count - f0);
        if (chunks > 1) stage(f0, cw);
        int xo[kWords];  // the slot's feature row in the tile
        float th[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int s = 32 * w + lane;
          const int off = (s < P::kInternal ? tf[s] : -1) - f0;
          const bool here = (unsigned)off < (unsigned)cw;
          xo[w] = (here ? off : 0) * kTileStride;
          th[w] = here ? tv[s] : nan;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {  // rows past n are zeros: their bits go unread
          const uint32_t mine = lane == j ? ~0u : 0u;
#pragma unroll
          for (int w = 0; w < kWords; ++w) own[w] |= __ballot_sync(~0u, x_s[xo[w] + j] >= th[w]) & mine;
        }
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) bits[w * 32 + lane] = own[w];
      __syncwarp();
    }
    int node = 0;
#pragma unroll
    for (int level = 0; level < H; ++level) {  // node < kInternal above the leaf level
      if (tf[node] >= 0) node = 2 * node + 1 + (int)((bits[(node >> 5) * 32 + lane] >> (node & 31)) & 1u);
    }
    acc += tv[node] / t_real;
  }
  if (lane < rows) out[row0 + lane] = acc;
}

template <int H>
int launch(const float* x, int n, int f, const int* fe, const float* va, int t, float* o, cudaStream_t s) {
  const int chunk = f < kMaxChunk ? f : kMaxChunk;
  const size_t smem = smem_bytes<H>(chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(dense_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  dense_kernel<H><<<(unsigned)blocks, kThreads, smem, s>>>(x, n, f, fe, va, t, chunk, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Mean path length over trees, accumulated as sum of pl / t in tree order.
// X: f32[n, f] row-major; feat (i32, -1 at leaves and holes) and val (f32
// merged plane): [t, 2^(h+1)-1] in heap order; out: f32[n]. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int dense_mean(const void* X, int n, int f, const void* feat,
                          const void* val, int t, int h, void* out, void* stream) {
  if (h < 0 || h > kMaxHeight || f <= 0 || t <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const int* fe = static_cast<const int*>(feat);
  const float* va = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  switch (h) {
    case 0: return launch<0>(x, n, f, fe, va, t, o, s);
    case 1: return launch<1>(x, n, f, fe, va, t, o, s);
    case 2: return launch<2>(x, n, f, fe, va, t, o, s);
    case 3: return launch<3>(x, n, f, fe, va, t, o, s);
    case 4: return launch<4>(x, n, f, fe, va, t, o, s);
    case 5: return launch<5>(x, n, f, fe, va, t, o, s);
    case 6: return launch<6>(x, n, f, fe, va, t, o, s);
    case 7: return launch<7>(x, n, f, fe, va, t, o, s);
    case 8: return launch<8>(x, n, f, fe, va, t, o, s);
    case 9: return launch<9>(x, n, f, fe, va, t, o, s);
    default: return launch<10>(x, n, f, fe, va, t, o, s);
  }
}
