// Gather-free dense level walk of a standard isolation forest, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel isoforest_tpu/ops/pallas_traversal.py::
// _standard_pallas (kernel body _standard_kernel). Same function and the
// same dense nature: for every row and tree, EVERY internal slot's
// comparison x[feature[m]] >= value[m] is evaluated, reach propagates level
// by level over the heap, and the reached leaf's merged value
// (depth + c(numInstances)) is the tree's path length. The row's result
// accumulates `acc += pl / T` tree by tree, in tree order, as the source of
// _standard_kernel does (pallas_traversal.py:190).
//
// What bounds it on this card: issued operations. Per row and tree it
// evaluates all 2^(h+1)-1 slots (511 at h = 8): two shared-memory reads, a
// select of x[f] and a compare each, 5e10 slot evaluations at the 1M-row x
// 100-tree headline, against 28 MB of X and output (about 8 us of HBM
// time). That is the dense algorithm's own cost: the function it computes
// needs only the compares on each row's path, as the walk (walk.cu) does.
//
// What the design does about it:
//  * One thread per row; every thread of a block reads the same slot at the
//    same time, so one tree's feature and value tables (4 KB at h = 8),
//    staged in shared memory, are read as broadcasts without bank
//    conflicts.
//  * A level's reach and go-right bits are 32-bit masks in registers
//    (2^h / 32 words: 8 at h = 8); the next level's reach is the bit
//    interleave of (reach & internal & ~right, reach & internal & right),
//    so propagating reach is a few integer ops per 32 slots.
//  * At most one slot per level is reached, so the tree's path length is
//    the exit leaf's value exactly (the dense sum adds only +0.0 besides).
//    The plain version sums reach * leaf value; the two agree bit for bit.
//    `pl / T` is a true division (no --use_fast_math), the same on every
//    device.
//  * Rows of up to 12 features (the JAX package's select/one-hot split,
//    dense_traversal.py:70) keep them in registers and pick x[f] with a
//    select chain; wider rows read x[f] through L1. Both are exact: there is
//    no one-hot product, so nothing can round through TF32.
//
// Height fence: kMaxHeight = 10. The leaf level's reach mask then takes 32
// registers (2^10 / 32 words; at h = 11 the mask alone would be 64 of a
// thread's 255 registers, beside the features and the loop state), and one
// tree's tables 2047 slots x 8 B = 16 KB of static shared memory. The
// wrapper raises a ValueError above it; the walk kernel has no fence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeight = 10;
constexpr int kSelectMaxFeatures = 12;
constexpr long long kMaxBlocks = 65535;

// Bits 0..15 of v moved to the even bit positions 0, 2, ..., 30.
__device__ __forceinline__ uint32_t spread16(uint32_t v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

template <int H, bool kRegs>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ X, int n, int f_count,
             const int* __restrict__ feat, const float* __restrict__ val,
             int t_count, float* __restrict__ out) {
  constexpr int kSlots = (1 << (H + 1)) - 1;
  constexpr int kWords = (1 << H) > 32 ? (1 << H) / 32 : 1;
  __shared__ int s_feat[kSlots];
  __shared__ float s_val[kSlots];
  const float t_real = (float)t_count;

  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += (long long)gridDim.x * blockDim.x) {
    const long long row = base + threadIdx.x;
    const bool active = row < n;
    const float* x = X + (active ? row : 0) * (long long)f_count;
    float xr[kRegs ? kSelectMaxFeatures : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int k = 0; k < kSelectMaxFeatures; ++k) xr[k] = (active && k < f_count) ? x[k] : 0.f;
    }
    float acc = 0.f;
    for (int t = 0; t < t_count; ++t) {
      __syncthreads();  // the previous tree is no longer read
      for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
        s_feat[i] = feat[(long long)t * kSlots + i];
        s_val[i] = val[(long long)t * kSlots + i];
      }
      __syncthreads();
      if (!active) continue;

      uint32_t reach[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) reach[w] = 0u;
      reach[0] = 1u;  // the root
      float pl = 0.f;
#pragma unroll
      for (int level = 0; level <= H; ++level) {
        const int width = 1 << level;
        const int bits = width < 32 ? width : 32;
        const int words = width < 32 ? 1 : width / 32;
        const int first = width - 1;  // heap slot of the level's first node
        // Descending words, so the next level's words 2w and 2w+1 overwrite
        // only words of this level that were already read.
#pragma unroll
        for (int w = words - 1; w >= 0; --w) {
          uint32_t internal = 0u;
          uint32_t right = 0u;
          for (int j = 0; j < bits; ++j) {
            const int f = s_feat[first + 32 * w + j];
            const float v = s_val[first + 32 * w + j];
            float xv;
            if constexpr (kRegs) {
              xv = 0.f;
#pragma unroll
              for (int k = 0; k < kSelectMaxFeatures; ++k) xv = (f == k) ? xr[k] : xv;
            } else {
              xv = __ldg(x + (f >= 0 ? f : 0));
            }
            internal |= (uint32_t)(f >= 0) << j;
            // NaN compares false and goes left, as on every JAX path
            right |= (uint32_t)(xv >= v) << j;
          }
          const uint32_t r = reach[w];
          const uint32_t at_leaf = r & ~internal;
          if (at_leaf) pl = s_val[first + 32 * w + __ffs(at_leaf) - 1];
          if (level < H) {
            const uint32_t alive = r & internal;
            const uint32_t go_left = alive & ~right;
            const uint32_t go_right = alive & right;
            if (width >= 32) {
              reach[2 * w + 1] = spread16(go_left >> 16) | (spread16(go_right >> 16) << 1);
            }
            reach[2 * w] = spread16(go_left) | (spread16(go_right) << 1);
          }
        }
      }
      acc += pl / t_real;
    }
    if (active) out[row] = acc;
  }
}

template <int H>
void launch(bool regs, int blocks, cudaStream_t s, const float* x, int n, int f,
            const int* fe, const float* va, int t, float* o) {
  if (regs) {
    dense_kernel<H, true><<<blocks, kThreads, 0, s>>>(x, n, f, fe, va, t, o);
  } else {
    dense_kernel<H, false><<<blocks, kThreads, 0, s>>>(x, n, f, fe, va, t, o);
  }
}

}  // namespace

// Mean path length over trees, accumulated as sum of pl / t in tree order.
// X: f32[n, f] row-major; feat (i32, -1 at leaves and holes) and val (f32
// merged plane): [t, 2^(h+1)-1] in heap order; out: f32[n]. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int dense_mean(const void* X, int n, int f, const void* feat,
                          const void* val, int t, int h, void* out, void* stream) {
  if (h < 0 || h > kMaxHeight || f <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  long long blocks = ((long long)n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool regs = f <= kSelectMaxFeatures;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const int* fe = static_cast<const int*>(feat);
  const float* va = static_cast<const float*>(val);
  float* o = static_cast<float*>(out);
  const int b = (int)blocks;
  switch (h) {
    case 0: launch<0>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 1: launch<1>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 2: launch<2>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 3: launch<3>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 4: launch<4>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 5: launch<5>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 6: launch<6>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 7: launch<7>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 8: launch<8>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 9: launch<9>(regs, b, s, x, n, f, fe, va, t, o); break;
    case 10: launch<10>(regs, b, s, x, n, f, fe, va, t, o); break;
  }
  return (int)cudaGetLastError();
}
