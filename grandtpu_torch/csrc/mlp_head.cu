// The dense classifier's eval forward (the 2-layer MLP of nn/mlp.py in
// eval mode) as one kernel a chunk of rows, with no intermediate in device
// memory.
//
// It replaces no TPU kernel. grandtpu/nn/mlp.py:130 apply_mlp was one XLA
// program, which kept its [rows, hidden] activation where XLA put it; the
// port ran MLP.forward as cuBLAS's f32 GEMMs with a dozen elementwise and
// reduction passes around them, each over the [rows, hidden] activation
// in device memory (10 GB a pass at Amazon2M's 2.45M rows and hidden
// 1024). For each row x [F] it computes, as MLP.forward does in eval:
//
//   x  = x / (1e-12 + |x|)                                  (node_norm)
//   x  = ((x - m0) * rsqrt(v0 + eps)) * g0 + b0             (use_bn)
//   h  = relu(W0 x + c0)                                    [H]
//   h  = h / (1e-12 + |h|)                                  (node_norm)
//   h  = ((h - m1) * rsqrt(v1 + eps)) * g1 + b1             (use_bn)
//   y  = W1 h + c1                                          [C]
//
// The input's norm and affine are applied to the x tile in shared memory
// in that order. The hidden norm is one scalar a row and eval BN an affine
// map a column, so both are folded past W1 instead of kept in their order
// with a second sweep over h (which would mean keeping all of a row's
// hidden units, or computing them twice): with s = rsqrt(v1 + eps) * g1
// and t = b1 - m1 * s,
//
//   y  = (sum_j h_j s_j W1[c,j]) / (1e-12 + |h|) + sum_j t_j W1[c,j] + c1
//
// so a hidden tile's relu output is used once, for its sum of squares and
// for the product with W1's columns scaled by s, and then dropped. The
// arithmetic is f32 on the FMA pipes (no TF32); the sums run in another
// order than cuBLAS's, so the logits agree with MLP.forward's to rounding
// (nn/mlp_head.py eval_head_plain is the same arithmetic in torch ops).
//
// What bounds it on an H100: f32 FLOPs. 2 F H + 2 H C a row (Amazon2M:
// 301K, 737 GFLOP for 2.45M rows, 11.0 ms at 67 TFLOP/s), against 4 F +
// 4 C bytes a row (1.4 GB, 0.4 ms) and weights that stay in L2.
//
// The design:
// - A block takes kBM rows and one tile of kHT hidden units; the
//   ceil(H / kHT) blocks of a row block form a thread block cluster (at
//   most 8, so H <= 1024). A 10,000-row chunk at H 1024 is 79 x 8 = 632
//   blocks, 2 resident an SM, where one block a row block would fill 79 of
//   132 SMs.
// - Chunks overlap: each launch is a programmatic dependent launch, and
//   its blocks let the next launch start as soon as they have all
//   started, so a chunk's blocks fill the SMs its predecessor's last wave
//   leaves idle. A launch whose input the launches before it on the stream
//   may still be writing (the caller says which: the first chunk) first
//   waits for them (griddepcontrol.wait), and only then lets the next
//   launch start.
// - Each block first sums the squares of the input rows over its share of
//   the K tiles; the cluster adds the shares through distributed shared
//   memory.
// - The first product is a register-tiled outer product: 256 threads,
//   8 x 8 outputs each (rows and hidden units in two groups of four), a
//   warp 4 row groups by 8 hidden groups, so that each of its float4 loads
//   from shared memory reads 64 or 128 distinct bytes. K tiles of kBK
//   features are double-buffered in shared memory and prefetched into
//   registers while the previous tile computes; the x tile is normalised
//   and BN-transformed as it is stored (a thread 4 rows by 2 features,
//   float4 stores).
// - Its epilogue adds the bias, applies relu, sums each row's squares over
//   the 8 threads of its row group in the warp (shuffles), and stores the
//   [kBM, kHT] tile to shared memory, over the dead K tiles.
// - The second product reads that tile against W1's columns scaled by s
//   (loaded at the block's start, a warp a class, with that class's sum of
//   t terms), 8 rows x 3 classes a thread, into [kBM, kCT] partial logits.
// - The cluster's blocks then add their partials, sums of squares and t
//   terms through distributed shared memory, each block a slice of the
//   rows, in block order (the same sums on every run), apply the norm and
//   the bias, and write the logits: the only store to device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128;       // rows a block
constexpr int kRQ = kBM / 4;   // a K tile's row quads
constexpr int kHT = 128;       // hidden units a block
constexpr int kBK = 16;        // features a K tile
constexpr int kCT = 48;        // the class tile: C <= kCT
constexpr int kMaxSplit = 8;   // blocks a cluster (portable): H <= 1024
constexpr int kHS = kHT + 4;   // row stride of the hidden tile and of w1s
static_assert(kThreads == 2 * kBM && kRQ * 8 == kThreads,
              "a K tile's loads: 4 rows by 2 features a thread");

// Shared memory, in floats. Region A holds in turn the input rows' squares
// (8 x kBM), the K tiles (xs, ws; two buffers), the hidden tile hs, then
// the partial logits with the slice's denominators and t sums after them.
constexpr int kTileFloats = 2 * kBK * (kBM + kHT);
constexpr int kRegionA = kBM * kHS;
static_assert(kTileFloats <= kRegionA && 8 * kBM <= kRegionA
                  && kBM * kCT + kBM + kCT <= kRegionA,
              "region A");
constexpr int kW1sFloats = kCT * kHS;
// region A, w1s, inv_x, xsp, ssp (2 kBM), tb; then a float4 a feature
constexpr int kFixedFloats = kRegionA + kW1sFloats + 4 * kBM + kCT;
static_assert(kFixedFloats % 4 == 0, "the BN table is 16-byte aligned");
constexpr size_t kMaxSmem = 232448;   // an H100 block's most

size_t smem_bytes(int F, int use_bn) {
  return sizeof(float) * (kFixedFloats + (use_bn ? 4 * (size_t)F : 0));
}

struct Head {
  const float* x;                       // [rows, F]
  const float* w0;                      // [H, F]
  const float* c0;                      // [H]
  const float* w1;                      // [C, H]
  const float* c1;                      // [C]
  const float *m0, *v0, *g0, *b0;       // BN over F (use_bn)
  const float *m1, *v1, *g1, *b1;       // BN over H (use_bn)
  float* out;                           // [rows, C]
  int rows, F, H, C, use_bn, node_norm;
  int vec2;                             // x and w0 rows 8-byte aligned, F even
  int overlap;                          // no wait for the launches before
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the cluster's first n blocks of the float at `local` in each
// one's shared memory, in block order (all loads in flight at once)
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cluster,
                                             float* local, int n) {
  float v[kMaxSplit];
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q)
    v[q] = q < n ? *cluster.map_shared_rank(local, q) : 0.f;
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxSplit; ++q) t += v[q];
  return t;
}

// x[k], x[k + 1] of a row (0 past F or off the rows)
__device__ __forceinline__ float2 load_pair(const float* row, int k, int F,
                                           bool ok, int vec2) {
  if (!ok || k >= F) return make_float2(0.f, 0.f);
  if (vec2) return __ldg(reinterpret_cast<const float2*>(row + k));
  return make_float2(__ldg(row + k), k + 1 < F ? __ldg(row + k + 1) : 0.f);
}

__global__ void __launch_bounds__(kThreads, 2) mlp_head_kernel(Head p) {
  extern __shared__ __align__(16) float smem[];
  float* const xss = smem;                           // [8][kBM]
  float* const xs = smem;                            // [2][kBK][kBM]
  float* const ws = smem + 2 * kBK * kBM;            // [2][kBK][kHT]
  float* const hs = smem;                            // [kBM][kHS]
  float* const part = smem;                          // [kBM][kCT]
  float* const den = smem + kBM * kCT;               // [kBM]
  float* const tbs = den + kBM;                      // [kCT]
  float* const w1s = smem + kRegionA;                // [kCT][kHS]
  float* const inv_x = w1s + kW1sFloats;             // [kBM]
  float* const xsp = inv_x + kBM;                    // [kBM]
  float* const ssp = xsp + kBM;                      // [2][kBM]
  float* const tb = ssp + 2 * kBM;                   // [kCT]
  float4* const bn0 = reinterpret_cast<float4*>(tb + kCT);  // [F]: m r g b

  cg::cluster_group cluster = cg::this_cluster();
  // what the launches before this one wrote is read only after this wait;
  // the next launch starts once every block has passed it
  if (!p.overlap) asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h0 = split * kHT;
  const int F = p.F, H = p.H, C = p.C;

  // BN0's table by feature
  if (p.use_bn) {
#pragma unroll 4
    for (int k = tid; k < F; k += kThreads)
      bn0[k] = make_float4(__ldg(p.m0 + k), rsqrtf(__ldg(p.v0 + k) + p.eps),
                           __ldg(p.g0 + k), __ldg(p.b0 + k));
  }
  // W1's columns of this tile scaled by BN1's s (a warp a class, a lane 4
  // hidden units), and each class's sum of t terms
  {
    const int j = lane * 4;
    float s4[4], t4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = h0 + j + i;
      s4[i] = jj < H ? 1.f : 0.f;
      t4[i] = 0.f;
      if (jj < H && p.use_bn) {
        s4[i] = rsqrtf(__ldg(p.v1 + jj) + p.eps) * __ldg(p.g1 + jj);
        t4[i] = __ldg(p.b1 + jj) - __ldg(p.m1 + jj) * s4[i];
      }
    }
    float4 w[kCT / kWarps];
#pragma unroll
    for (int q = 0; q < kCT / kWarps; ++q) {
      const int c = warp + kWarps * q;
      w[q] = c < C && h0 + j < H
                 ? __ldg(reinterpret_cast<const float4*>(
                       p.w1 + (int64_t)c * H + h0 + j))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kCT / kWarps; ++q) {
      const int c = warp + kWarps * q;
      float t = w[q].x * t4[0];
      t = fmaf(w[q].y, t4[1], t);
      t = fmaf(w[q].z, t4[2], t);
      t = fmaf(w[q].w, t4[3], t);
      t = warp_sum(t);
      if (lane == 0) tb[c] = t;
      *reinterpret_cast<float4*>(w1s + c * kHS + j) =
          make_float4(w[q].x * s4[0], w[q].y * s4[1], w[q].z * s4[2],
                      w[q].w * s4[3]);
    }
  }

  // the K tiles' loads: x as 4 rows by 2 features a thread, w0 as 4 hidden
  // units by 2 features; row i of a group at base + i F
  const int rq = tid % kRQ, xk = (tid / kRQ) * 2;
  const int hq = tid & 31;
  const float* const wbase = p.w0 + (int64_t)(h0 + hq * 4) * F;
  const int wrows = H - h0 - hq * 4;
  const int ty = (warp >> 1) * 4 + (lane >> 3);      // 0 .. 15
  const int tx = (warp & 1) * 8 + (lane & 7);        // 0 .. 15

  const int row0 = blockIdx.y * kBM;
  const int nrows = min(kBM, p.rows - row0);
  const float* const xbase = p.x + (int64_t)(row0 + rq * 4) * F;
  const int xrows = nrows - rq * 4;
  float2 xr[4], wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xr[i] = load_pair(xbase + i * F, k0 + xk, F, i < xrows, p.vec2);
      wr[i] = load_pair(wbase + i * F, k0 + xk, F, i < wrows, p.vec2);
    }
  };
  load(0);   // in flight during the rows' squares

  // the input rows' squares: this block's share of the K tiles, then the
  // cluster's sum in block order
  if (p.node_norm) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k0 = split * kBK; k0 < F; k0 += nsplit * kBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = load_pair(xbase + i * F, k0 + xk, F, i < xrows,
                                   p.vec2);
        s[i] = fmaf(v.x, v.x, s[i]);
        s[i] = fmaf(v.y, v.y, s[i]);
      }
    }
    *reinterpret_cast<float4*>(xss + (tid / kRQ) * kBM + rq * 4) =
        make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();
    if (tid < kBM) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) t += xss[g * kBM + tid];
      xsp[tid] = t;
    }
    cluster.sync();
    if (tid < kBM)
      inv_x[tid] = 1.f / (1e-12f + sqrtf(cluster_sum(cluster, xsp + tid,
                                                      nsplit)));
  } else if (tid < kBM) {
    inv_x[tid] = 1.f;
  }

  // ---- the first product: acc = x' W0^T over the tile's hidden units ----
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto store = [&](int k0, int buf) {
    const float4 ix = *reinterpret_cast<const float4*>(inv_x + rq * 4);
    const float ixs[4] = {ix.x, ix.y, ix.z, ix.w};
    float* const xb = xs + buf * kBK * kBM;
    float* const wb = ws + buf * kBK * kHT;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int k = k0 + xk + d;
      float v[4] = {d ? xr[0].y : xr[0].x, d ? xr[1].y : xr[1].x,
                    d ? xr[2].y : xr[2].x, d ? xr[3].y : xr[3].x};
      if (k < F) {
        const float4 bn = p.use_bn ? bn0[k] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] *= ixs[i];
          if (p.use_bn) {
            v[i] = (v[i] - bn.x) * bn.y;
            v[i] = v[i] * bn.z + bn.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = 0.f;
      }
      *reinterpret_cast<float4*>(xb + (xk + d) * kBM + rq * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(wb + (xk + d) * kHT + hq * 4) =
          d ? make_float4(wr[0].y, wr[1].y, wr[2].y, wr[3].y)
            : make_float4(wr[0].x, wr[1].x, wr[2].x, wr[3].x);
    }
  };
  const int tiles = (F + kBK - 1) / kBK;
  __syncthreads();   // inv_x; xss was read before the tiles overwrite it
  store(0, 0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) load((t + 1) * kBK);
    const float* const xb = xs + buf * kBK * kBM;
    const float* const wb = ws + buf * kBK * kHT;
    const int kn = min(kBK, F - t * kBK);   // the rest of the tile is zeros
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      if (kk >= kn) break;
#pragma unroll
      for (int k = kk; k < kk + 4; ++k) {
        const float* const xk4 = xb + k * kBM + ty * 4;
        const float* const wk4 = wb + k * kHT + tx * 4;
        const float4 a0 = *reinterpret_cast<const float4*>(xk4);
        const float4 a1 = *reinterpret_cast<const float4*>(xk4 + kBM / 2);
        const float4 b0 = *reinterpret_cast<const float4*>(wk4);
        const float4 b1 = *reinterpret_cast<const float4*>(wk4 + 64);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (t + 1 < tiles) store((t + 1) * kBK, buf ^ 1);
    __syncthreads();
  }

  // ---- epilogue: bias, relu, each row's squares, the tile to hs ----
  {
    float bias[8];
    bool live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hj = h0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      live[j] = hj < H;
      bias[j] = live[j] ? __ldg(p.c0 + hj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float h = live[j] ? fmaxf(acc[i][j] + bias[j], 0.f) : 0.f;
        acc[i][j] = h;
        s = fmaf(h, h, s);
      }
      // the row group's 8 threads of this warp (the other 8: warp ^ 1)
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int r = i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4;
      if ((lane & 7) == 0) ssp[(warp & 1) * kBM + r] = s;
      float* const dst = hs + r * kHS;
      *reinterpret_cast<float4*>(dst + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();   // hs, w1s, tb

  // ---- the second product: the tile's partial logits ----
  // a thread's rows tr + RG i and classes tc + 16 q
  constexpr int RG = kBM / 8;
  const int tr = tid >> 4, tc = tid & 15;
  float o[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q) o[i][q] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kHT; j += 4) {
    float4 wv[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      wv[q] = *reinterpret_cast<const float4*>(w1s + (tc + 16 * q) * kHS + j);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 hv =
          *reinterpret_cast<const float4*>(hs + (tr + RG * i) * kHS + j);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        o[i][q] = fmaf(hv.x, wv[q].x, o[i][q]);
        o[i][q] = fmaf(hv.y, wv[q].y, o[i][q]);
        o[i][q] = fmaf(hv.z, wv[q].z, o[i][q]);
        o[i][q] = fmaf(hv.w, wv[q].w, o[i][q]);
      }
    }
  }
  __syncthreads();   // every read of hs before part overwrites it
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      part[(tr + RG * i) * kCT + tc + 16 * q] = o[i][q];
  cluster.sync();    // every block's part, ssp and tb

  // ---- the cluster's sum: this block's slice of the rows ----
  const int rp = (kBM + nsplit - 1) / nsplit;
  const int r_lo = split * rp, r_hi = min(kBM, r_lo + rp);
  for (int r = r_lo + tid; r < r_hi; r += kThreads)
    den[r] = 1e-12f + sqrtf(cluster_sum(cluster, ssp + r, nsplit)
                            + cluster_sum(cluster, ssp + kBM + r, nsplit));
  for (int c = tid; c < kCT; c += kThreads)
    tbs[c] = cluster_sum(cluster, tb + c, nsplit);
  __syncthreads();   // den, tbs
  const int n_el = max(0, r_hi - r_lo) * kCT;
  for (int e = tid; e < n_el; e += kThreads) {
    const int r = r_lo + e / kCT, c = e % kCT;
    if (c >= C || r >= nrows) continue;
    const float a = cluster_sum(cluster, part + r * kCT + c, nsplit);
    float y = p.node_norm ? a / den[r] : a;
    y = (y + tbs[c]) + __ldg(p.c1 + c);
    p.out[(int64_t)(row0 + r) * C + c] = y;
  }
  cluster.sync();    // no block leaves while another reads its memory
}

cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  done = err == cudaSuccess;
  return err;
}

// a cluster of the row block's nsplit blocks; a programmatic dependent
// launch
cudaLaunchConfig_t launch_config(int nsplit, int row_blocks, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, row_blocks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

bool shape_ok(int F, int H, int C) {
  return F >= 1 && H >= 1 && H <= kHT * kMaxSplit && H % 4 == 0 && C >= 1
         && C <= kCT;
}

}  // namespace

// Whether the kernel takes a model of F features, H hidden units and C
// classes (with use_bn, its BN table in a block's shared memory): C <= 48,
// H <= 1024 and a multiple of 4. The one place that decides it: the
// wrapper's dispatch asks here, and mlp_head_f32 refuses what this refuses.
extern "C" int mlp_head_takes(int F, int H, int C, int use_bn) {
  return shape_ok(F, H, C) && smem_bytes(F, use_bn) <= kMaxSmem;
}

// The launch's shape and what the card makes of it, for F features, H
// hidden units and use_bn: out[0] threads a block, [1] rows a block, [2]
// hidden units a block, [3] the class tile, [4] the largest H, [5] dynamic
// shared memory bytes, [6] registers a thread, [7] local (spilled) bytes a
// thread, [8] blocks an SM, [9] clusters the card holds at once.
extern "C" int mlp_head_config(int F, int H, int use_bn, int* out) {
  if (!shape_ok(F, H, 1)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(F, use_bn);
  out[0] = kThreads;
  out[1] = kBM;
  out[2] = kHT;
  out[3] = kCT;
  out[4] = kHT * kMaxSplit;
  out[5] = static_cast<int>(smem);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, mlp_head_kernel);
  if (err != cudaSuccess) return err;
  out[6] = fa.numRegs;
  out[7] = static_cast<int>(fa.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], mlp_head_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config((H + kHT - 1) / kHT, 1, smem, nullptr, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&out[9], mlp_head_kernel, &cfg));
}

// Logits [rows, C] of the eval MLP for x [rows, F], all f32 and contiguous
// on the card: w0 [H, F], c0 [H], w1 [C, H] (16-byte aligned), c1 [C];
// with use_bn the eval BatchNorms' running means, variances, weights and
// biases over F (m0, v0, g0, b0) and H (m1, v1, g1, b1), else those may be
// null. One launch on `stream`. With overlap it may run beside the launch
// before it on the stream, and reads nothing that launch writes: the
// caller's promise that every earlier write it reads was made before that
// launch. Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// shape that mlp_head_takes refuses, or more than 65535 x 128 rows).
extern "C" int mlp_head_f32(const float* x, const float* w0, const float* c0,
                            const float* w1, const float* c1,
                            const float* m0, const float* v0,
                            const float* g0, const float* b0,
                            const float* m1, const float* v1,
                            const float* g1, const float* b1, float* out,
                            int rows, int F, int H, int C, int use_bn,
                            int node_norm, float eps, int overlap,
                            void* stream) {
  if (rows < 0 || !mlp_head_takes(F, H, C, use_bn)
      || (reinterpret_cast<uintptr_t>(w1) & 15) != 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t row_blocks = (static_cast<int64_t>(rows) + kBM - 1) / kBM;
  const size_t smem = smem_bytes(F, use_bn);
  if (row_blocks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  const int vec2 = F % 2 == 0 && ((reinterpret_cast<uintptr_t>(x)
                                   | reinterpret_cast<uintptr_t>(w0)) & 7) == 0;
  const Head h = {x,  w0, c0, w1, c1, m0,  v0,     g0,        b0,
                  m1, v1, g1, b1, out, rows, F, H, C, use_bn, node_norm,
                  vec2, overlap, eps};
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config((H + kHT - 1) / kHT, static_cast<int>(row_blocks), smem,
                    static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, mlp_head_kernel, h);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
