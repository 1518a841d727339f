// Adam: grandtpu's optimizer step over a list of leaves, in one launch.
//
// Replaces the XLA program of grandtpu/train/step.py:45 make_optimizer,
// optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps),
// scale(-lr)) followed by optax.apply_updates, which XLA runs as one fused
// elementwise loop a leaf. An element goes through optax's order (optax
// 0.2.6: add_decayed_weights, tree_update_moment,
// tree_update_moment_per_elem_norm, tree_bias_correction, scale,
// apply_updates):
//
//   g  = grad (0 where the leaf has no gradient), + wd * p when wd > 0
//   m  = (1 - b1) * g + b1 * m
//   v  = (1 - b2) * (g * g) + b2 * v
//   mh = m / bc1,  vh = v / bc2          bc = 1 - b^count
//   p  = p + (-lr) * (mh / (sqrt(vh) + eps))
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), so that nvcc contracts none of them into a fused multiply-
// add: the plain version (train/adam.py adam_update_plain), one torch op
// an operation, gives the same bits. The scalars come from the wrapper
// rounded to f32 as JAX rounds its weak-typed Python scalars ((1 - b1) and
// (1 - b2) taken in double first). bc1 and bc2 are read from device memory
// at every launch, never passed by value, so that a CUDA graph replay of a
// step sees that step's count.
//
// What bounds it on an H100: bytes. It reads p, g, m, v and writes p, m,
// v, 28 bytes an element (24 for a leaf with no gradient) for 12 flops.
// The MAG table [2780000, 64]: 177.9M elements, 4.98 GB, 1.49 ms at 3.35
// TB/s; the reddit MLP's leaves 0.31M elements, 8.7 MB.
//
// Design: the leaves' pointers and lengths travel by value in the launch's
// arguments (kMaxLeaves of them, 3.1 KB, under the 4 KB of kernel
// arguments every CUDA 12 card takes; more leaves take more launches), so
// there is no host table to upload and a graph holds them with the launch.
// The leaves are cut into tiles of kTile elements; a block takes one tile
// and finds its leaf by a binary search in the tiles' prefix sums. A
// thread takes 4 consecutive elements, with 16-byte loads and stores where
// all of the leaf's arrays are 16-byte aligned and the 4 are inside the
// leaf, else one element at a time; the arithmetic is the same either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int64_t kTile = kThreads * kPerThread;

struct Leaf {
  float* p;
  const float* g;   // null: a zero gradient
  float* m;
  float* v;
  int64_t n;
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int64_t tile0[kMaxLeaves + 1];   // each leaf's first tile, then the total
  int count;
};

struct Hyper {
  float neg_lr, wd, b1, omb1, b2, omb2, eps;
  int decay;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float bc1, float bc2,
                                         const Hyper& h) {
  if (h.decay) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float mh = __fdiv_rn(m, bc1);
  const float vh = __fdiv_rn(v, bc2);
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(Leaves ls, const float* __restrict__ bc1_ptr,
                const float* __restrict__ bc2_ptr, Hyper h) {
  const int64_t t = blockIdx.x;
  int lo = 0, hi = ls.count - 1;   // the last leaf whose first tile <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ls.tile0[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const Leaf L = ls.leaf[lo];
  const int64_t i0 = (t - ls.tile0[lo]) * kTile + threadIdx.x * kPerThread;
  if (i0 >= L.n) return;
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const bool vec = ((reinterpret_cast<uintptr_t>(L.p) |
                     reinterpret_cast<uintptr_t>(L.g) |
                     reinterpret_cast<uintptr_t>(L.m) |
                     reinterpret_cast<uintptr_t>(L.v)) & 15) == 0;
  if (vec && i0 + kPerThread <= L.n) {
    float4 p = *reinterpret_cast<const float4*>(L.p + i0);
    const float4 g = L.g ? *reinterpret_cast<const float4*>(L.g + i0)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 m = *reinterpret_cast<const float4*>(L.m + i0);
    float4 v = *reinterpret_cast<const float4*>(L.v + i0);
    adam_one(p.x, g.x, m.x, v.x, bc1, bc2, h);
    adam_one(p.y, g.y, m.y, v.y, bc1, bc2, h);
    adam_one(p.z, g.z, m.z, v.z, bc1, bc2, h);
    adam_one(p.w, g.w, m.w, v.w, bc1, bc2, h);
    *reinterpret_cast<float4*>(L.p + i0) = p;
    *reinterpret_cast<float4*>(L.m + i0) = m;
    *reinterpret_cast<float4*>(L.v + i0) = v;
    return;
  }
  for (int64_t i = i0; i < i0 + kPerThread && i < L.n; ++i) {
    float p = L.p[i], m = L.m[i], v = L.v[i];
    adam_one(p, L.g ? L.g[i] : 0.f, m, v, bc1, bc2, h);
    L.p[i] = p;
    L.m[i] = m;
    L.v[i] = v;
  }
}

}  // namespace

extern "C" int adam_max_leaves() { return kMaxLeaves; }

// One launch over num_leaves (1..kMaxLeaves) leaves of n[i] f32 elements:
// p[i], m[i], v[i] updated in place, g[i] read (null: a zero gradient).
// bc1, bc2: device pointers to 1 - b1^count and 1 - b2^count. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a leaf count outside
// 1..kMaxLeaves or a negative length; 0 and no launch when every leaf is
// empty).
extern "C" int adam_update_f32(void* const* p, void* const* g,
                               void* const* m, void* const* v,
                               const int64_t* n, int num_leaves,
                               const float* bc1, const float* bc2,
                               float neg_lr, float wd, float b1, float omb1,
                               float b2, float omb2, float eps, int decay,
                               void* stream) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  Leaves ls = {};
  int64_t tiles = 0;
  for (int i = 0; i < num_leaves; ++i) {
    if (n[i] < 0) return cudaErrorInvalidValue;
    ls.leaf[i] = {static_cast<float*>(p[i]), static_cast<const float*>(g[i]),
                  static_cast<float*>(m[i]), static_cast<float*>(v[i]), n[i]};
    ls.tile0[i] = tiles;
    tiles += (n[i] + kTile - 1) / kTile;
  }
  ls.tile0[num_leaves] = tiles;
  ls.count = num_leaves;
  if (tiles == 0) return 0;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const Hyper h = {neg_lr, wd, b1, omb1, b2, omb2, eps, decay};
  adam_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(ls, bc1, bc2, h);
  return static_cast<int>(cudaGetLastError());
}
