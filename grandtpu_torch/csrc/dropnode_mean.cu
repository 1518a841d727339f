// K1: gather + DropNode weighted mean for the dense-feature engine.
//
// Replaces the TPU program grandtpu/nn/dropnode.py::random_prop and its
// gather (gather_and_prop), as driven by grandtpu/train/step.py::_forward_k
// (train, K augmentations) and build_eval_step (eval, K = 1, nothing dropped):
//
//   out[k, b, :] = sum_j w[k,b,j] * features[cols[b,j], :] / (sum_j w[k,b,j] + 1e-12)
//   w[k,b,j]     = keep[k,b,j] ? vals[b,j] : 0        (keep == nullptr: all kept)
//
// What bounds it on an H100: bytes and latency, never flops (2 K flops a
// float loaded). The bytes the output needs are the distinct rows of the
// slots with a nonzero weight in some mask, read once. The eval forms,
// reddit [1,1230,602] (≈ 161 MB of distinct rows, 190 MB of slot rows) and
// Amazon2M [1,1410,100] (≈ 36 MB), are bytes: their time is set by how many
// gathered bytes each SM keeps in flight. The train forms are a chain of
// dependent steps (the slots' cols, weights and masks; the rows; the sums
// across warps) on few rows: reddit [2,250,602] (≈ 29 MB) is in between,
// Amazon2M [2,250,100] (≈ 5 MB) is latency and the launch.
//
// Design (redesigned for the H100; the first kernel gave a block a batch
// row, its threads striding over F, each thread loading all Ktop rows one
// float at a time in batches of 8 dependent loads):
// - A block takes one batch row (rows a block for 4 warps when a row has
//   fewer warps) and one tile of L * V features; the tiles of a row are
//   blocks of their own, so reddit's 250 train rows are 1,250 blocks of two
//   rows for 132 SMs.
// - The row's Ktop slots are shared out to the warps, `span` at a time,
//   enough to fill one batch of the warp's rows in flight (32 slots a warp
//   at reddit's float2, 8 at Amazon2M's float4). A warp loads its slots'
//   cols, values and K mask bytes together, one slot a lane, skips every
//   slot whose weight is 0 in every mask (padding, and slots that every
//   augmentation drops) with a ballot, and compacts the live ones into a
//   per-warp list in shared memory.
// - V is the widest aligned vector: float4 where F % 4 == 0 and features
//   is 16-byte aligned (Amazon2M's F 100: 400-byte rows, 25 float4 a row);
//   float2 where F % 2 == 0 and it is 8-byte aligned (reddit's F 602:
//   every other 2,408-byte row starts 8 bytes past a 16-byte boundary);
//   else one float (odd F, or a view that starts off the alignment). A lane
//   group of L lanes (a power of two up to 32) covers a tile; narrow rows put
//   32 / L groups in a warp, each taking every G-th live slot.
// - A group issues the rows of up to rows_in_flight(V) live slots (32 at
//   float2 and one float, 8 at float4) into registers before any multiply,
//   with loads that do not allocate in the L1 (a gathered row is read once).
// - The slots' weights for D are summed after the rows are issued, so no
//   chain waits on them.
// - A fixed-order sum, no float atomics: a lane adds its slots in list
//   order, a warp's groups meet by a fixed xor-shuffle tree, each warp
//   writes its partial numerators and weight sums into its own row of
//   shared memory, and after one barrier the block adds the warps' rows in
//   warp order and divides by D. The output is the same bits on every
//   call.
//
// A skipped slot is not read, so a non-finite feature row at a slot of
// weight 0 in every mask does not reach the output (grandtpu and the plain
// version multiply it by 0 and give NaN). K3 skips padding the same way.
//
// What was tried and not kept (device ms, reddit train / eval / mesh shard
// [2,125,602] / Amazon2M train / eval; NVIDIA H100 80GB HBM3, 700 W;
// tools/propagation_times.py k1, each beside the kept code in one call;
// PERF.md section 6). The kept code: 0.0159 / 0.0697 / 0.0104 /
// 0.0054 / 0.0170 (the parent kernel 0.0307 / 0.0869 / 0.0275 / 0.0112 /
// 0.0183).
// - 8 rows in flight at every V, 8 warps a row: 0.0227 / 0.0907 / 0.0133 /
//   0.0054 / 0.0181; 4 rows, 16 warps: 0.0257 / 0.1326 / 0.0143 / 0.0054 /
//   0.0267; 16 rows at every V: 0.0174 / 0.0856 / 0.0099 / 0.0062 / 0.0193.
//   Bytes in flight an SM set the eval forms' time; float4 with 16 rows
//   takes 64 registers of loads and fewer warps fit.
// - 16 rows at float2 (with the L1-bypassing loads): 0.0163 / 0.0793 /
//   0.0096 / 0.0055 / 0.0171: the mesh shard form gains 8 % from twice the
//   blocks, the reddit eval form loses 14 %.
// - Loads through the L1 (__ldg), else as kept at 16 rows: 0.0173 / 0.0859 /
//   0.0099 / 0.0054 / 0.0181.
// - Tiles row-fastest in the grid: 0.0176 / 0.0826 / 0.0104 / 0.0056 /
//   0.0183. Two or four vectors a lane (tiles of 128 or 256 floats at F
//   602): 0.0162 / 0.0884 / 0.0096 and 0.0267 / 0.0858 / 0.0141.
// - Register caps (__maxnreg__ 64, 80 or 96, for more warps an SM) spilled
//   and were slower: eval 0.0853, 0.0976, 0.0988.
// - A block a whole row, each warp reading whole rows (items of a chunk
//   and a slot, sums kept in shared rows): 0.0384 / 0.1160 / 0.0207 /
//   0.0073 / 0.0220; its 85-register blocks of 16 warps fit one an SM.
// - Thread-block clusters with a DSMEM reduction were not tried: the tiles
//   of a row already fill the card, and no reduction crosses a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;   // warps a block at most (a row's slot shares)
constexpr int kMinWarps = 4;    // rows a block fill this many warps
// live rows a lane group has in flight, by V (1, 2 or 4 floats a load)
__host__ __device__ constexpr int rows_in_flight(int V) {
  return V == 4 ? 8 : 32;
}
constexpr int kMaxSmem = 232448;   // an H100 block's shared memory

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// V neighbouring features of a row, as one load that does not allocate in
// the L1 (a gathered row is read once).
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) {
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v[0]) : "l"(p));
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];"
      : "=f"(v[0]), "=f"(v[1])
      : "l"(p));
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "l"(p));
}

// Shared memory: red [warps][K][tile] (each warp's partial numerators of
// the tile), dpart [warps][K] (its weight sums), then each warp's list of
// live slots: 32 cols and 32 x K weights.
template <int K, int V>
__global__ void __launch_bounds__(kMaxWarps * 32) dropnode_mean_kernel(
    const float* __restrict__ features, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const uint8_t* __restrict__ keep,
    float* __restrict__ out, int batch, int ktop, int num_features,
    int tiles, int span, int wpr, int lanes_log2) {
  constexpr int kU = rows_in_flight(V);   // live rows a group has in flight
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int rpb = nwarps / wpr;
  const int L = 1 << lanes_log2, G = 32 >> lanes_log2;
  const int chunk = L * V;
  const int tile = blockIdx.x % tiles;
  const int row0 = (blockIdx.x / tiles) * rpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* red = smem;
  float* dpart = red + nwarps * K * chunk;
  int32_t* ids = reinterpret_cast<int32_t*>(dpart + nwarps * K) +
                 warp * 32 * (1 + K);
  float* wl = reinterpret_cast<float*>(ids + 32);
  const int li = lane & (L - 1), grp = lane >> lanes_log2;
  const int rr = warp / wpr, sub = warp - rr * wpr;
  const int b = row0 + rr;
  const int f0 = tile * chunk + li * V;   // this lane's first feature

  // V > 1 only where V divides F, so the lane's V features are all in
  // the row or all past it
  const bool fin = f0 < num_features;

  float num[K][V], dsum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dsum[k] = 0.0f;
#pragma unroll
    for (int e = 0; e < V; ++e) num[k][e] = 0.0f;
  }
  for (int c0 = sub * span; b < batch && c0 < ktop; c0 += wpr * span) {
    // the slots' cols, values and mask bytes, loaded together
    const int j = c0 + lane;
    int32_t col = 0;
    float w[K];
    bool any = false;
    if (lane < span && j < ktop) {
      const int64_t bj = static_cast<int64_t>(b) * ktop + j;
      col = __ldg(cols + bj);
      const float v = __ldg(vals + bj);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool kept =
            keep == nullptr ||
            __ldg(keep + (static_cast<int64_t>(k) * batch + b) * ktop + j) != 0;
        w[k] = kept ? v : 0.0f;
        any |= w[k] != 0.0f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = 0.0f;
    }
    // a slot of weight 0 in every mask takes no gather
    const unsigned m = __ballot_sync(kFull, any);
    const int n = __popc(m);
    if (any) {
      const int at = __popc(m & ((1u << lane) - 1u));
      ids[at] = col;
#pragma unroll
      for (int k = 0; k < K; ++k) wl[at * K + k] = w[k];
    }
    __syncwarp();
    for (int i0 = grp; i0 < n; i0 += G * kU) {
      // the batch's rows all issued before any multiply
      float x[kU][V];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + G * u;
        if (i < n && fin) {
          load_vec(features + static_cast<int64_t>(ids[i]) * num_features + f0,
                   x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) x[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + G * u;
        if (i >= n) break;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float wk = wl[i * K + k];
#pragma unroll
          for (int e = 0; e < V; ++e) num[k][e] = fmaf(wk, x[u][e], num[k][e]);
        }
      }
    }
    // the weights for D, after the rows are issued
#pragma unroll
    for (int k = 0; k < K; ++k) dsum[k] += w[k];
    __syncwarp();                      // before the next list
  }
  // the groups' sums meet, then the warp's row of partial sums
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e)
      for (int o = L; o < 32; o <<= 1)
        num[k][e] += __shfl_xor_sync(kFull, num[k][e], o);
  if (grp == 0) {
    float* wred = red + warp * K * chunk + li * V;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) wred[k * chunk + e] = num[k][e];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = warp_sum(dsum[k]);
    if (lane == 0) dpart[warp * K + k] = d;
  }
  __syncthreads();
  // the warps' sums in warp order, over D
  for (int i = threadIdx.x; i < rpb * K * chunk; i += blockDim.x) {
    const int rr2 = i / (K * chunk);
    const int rem = i - rr2 * K * chunk;
    const int k = rem / chunk, hh = rem - k * chunk;
    const int b2 = row0 + rr2, fc = tile * chunk + hh;
    if (b2 >= batch || fc >= num_features) continue;
    float s = 0.0f, d = 0.0f;
    for (int sb = 0; sb < wpr; ++sb) {
      const int w2 = rr2 * wpr + sb;
      s += red[(w2 * K + k) * chunk + hh];
      d += dpart[w2 * K + k];
    }
    out[(static_cast<int64_t>(k) * batch + b2) * num_features + fc] =
        s / (d + 1e-12f);
  }
}

// The launch configuration (nn/dropnode.py::k1_config mirrors it;
// dropnode_mean_config reports it): V from F and the alignment; the fewest
// lanes L (a power of two up to 32) whose V-vectors cover F, L * V features
// a tile; a warp takes `span` slots at a time, enough to give each of its
// 32 / L groups rows_in_flight(V) rows (32 at most, more when Ktop is past
// 16 warps' worth); warps a row, one a share of the slots, up to 16; rows a
// block for 4 warps.
struct Config {
  int vec, lanes_log2, tiles, span, wpr, rpb;
  size_t smem;
};

inline Config pick_config(int ktop, int num_features, int K, int align) {
  Config c;
  c.vec = num_features % 4 == 0 && align % 4 == 0   ? 4
          : num_features % 2 == 0 && align % 2 == 0 ? 2
                                                    : 1;
  const int vecs = (num_features + c.vec - 1) / c.vec;
  c.lanes_log2 = 0;
  while ((1 << c.lanes_log2) < vecs && c.lanes_log2 < 5) ++c.lanes_log2;
  const int chunk = (1 << c.lanes_log2) * c.vec;
  c.tiles = (num_features + chunk - 1) / chunk;
  const int rows = (32 >> c.lanes_log2) * rows_in_flight(c.vec);
  const int share = (ktop + kMaxWarps - 1) / kMaxWarps;
  c.span = rows > share ? rows : share;
  if (c.span > 32) c.span = 32;
  const int shares = (ktop + c.span - 1) / c.span;
  c.wpr = shares < 1 ? 1 : (shares > kMaxWarps ? kMaxWarps : shares);
  c.rpb = c.wpr >= kMinWarps ? 1 : (kMinWarps + c.wpr - 1) / c.wpr;
  const size_t nwarps = static_cast<size_t>(c.rpb) * c.wpr;
  c.smem = nwarps * K * (chunk + 1) * sizeof(float) +
           nwarps * 32 * (1 + K) * sizeof(float);
  return c;
}

// features' alignment in floats: 4 (16 bytes), 2 (8) or 1
inline int feature_align(const float* features) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(features);
  return p % 16 == 0 ? 4 : p % 8 == 0 ? 2 : 1;
}

template <int K, int V>
cudaError_t launch(const Config& c, const float* features,
                   const int32_t* cols, const float* vals,
                   const uint8_t* keep, float* out, int batch, int ktop,
                   int num_features, cudaStream_t stream) {
  auto kernel = dropnode_mean_kernel<K, V>;
  if (c.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(c.smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks =
      static_cast<int64_t>((batch + c.rpb - 1) / c.rpb) * c.tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), c.rpb * c.wpr * 32, c.smem,
           stream>>>(features, cols, vals, keep, out, batch, ktop,
                     num_features, c.tiles, c.span, c.wpr, c.lanes_log2);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const float* features, const int32_t* cols,
                     const float* vals, const uint8_t* keep, float* out,
                     int batch, int ktop, int num_features,
                     cudaStream_t stream) {
  const Config c =
      pick_config(ktop, num_features, K, feature_align(features));
  if (c.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  switch (c.vec) {
    case 4: return launch<K, 4>(c, features, cols, vals, keep, out, batch, ktop, num_features, stream);
    case 2: return launch<K, 2>(c, features, cols, vals, keep, out, batch, ktop, num_features, stream);
    default: return launch<K, 1>(c, features, cols, vals, keep, out, batch, ktop, num_features, stream);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). num_aug is K, 1..8;
// keep may be null (eval: every entry kept, num_aug must be 1).
extern "C" int dropnode_mean_f32(const float* features, const int32_t* cols,
                                 const float* vals, const uint8_t* keep,
                                 float* out, int batch, int ktop,
                                 int num_features, int num_aug,
                                 void* stream) {
  if (batch == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_aug) {
    case 1: return launch_k<1>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 2: return launch_k<2>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 3: return launch_k<3>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 4: return launch_k<4>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 5: return launch_k<5>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 6: return launch_k<6>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 7: return launch_k<7>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 8: return launch_k<8>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The configuration dropnode_mean_f32 launches with for Ktop, F and K when
// features is aligned to `align` floats (4, 2 or 1): out[0..6] = V, lanes
// a group, tiles a row, span, warps a row, rows a block, shared bytes.
extern "C" int dropnode_mean_config(int ktop, int num_features, int num_aug,
                                    int align, int* out) {
  if (ktop < 0 || num_features < 1 || num_aug < 1 || align < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config c = pick_config(ktop, num_features, num_aug, align);
  out[0] = c.vec;
  out[1] = 1 << c.lanes_log2;
  out[2] = c.tiles;
  out[3] = c.span;
  out[4] = c.wpr;
  out[5] = c.rpb;
  out[6] = static_cast<int>(c.smem);
  return 0;
}
