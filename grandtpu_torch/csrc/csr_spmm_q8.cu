// quantize, K2-q8 and K2-q8mxu: the int8 forms of the propagation hop.
//
// Replaces the TPU programs of grandtpu/sparse/spmm.py's int8 path, as
// driven by grandtpu/infer/propagate.py::_propagate_device with precision
// int8 / int8mxu / int8cast:
//
// - quantize_columns (spmm.py:452): amax[f] = max_r |x[r, f]|;
//   scale[f] = amax / 127 (1 where amax is 0; rounded to bf16 for bf16 x,
//   which grandtpu divides in x's dtype); q = clamp(rint(x / scale), +-127)
//   with IEEE division and round-half-even, so q is bit for bit JAX's.
//   Two entry points, one launch each: column_absmax, a column-max
//   reduction (per-block partial maxima, then atomicMax on the float bits,
//   which orders non-negative floats); quantize_with_amax, whose blocks
//   each compute the column scales into shared memory, then quantize. An
//   int8 propagation runs column_absmax only for its first hop: each hop
//   takes the column maxima of the y it stores (below), so the next hop's
//   quantize is quantize_with_amax alone and y is read once, not twice (a
//   max is exact in any order: q is the same bits). The row-partitioned
//   int8 propagation (grandtpu/dist/spmm_shard.py:341-344) takes the max
//   of the shards' maxima between the two.
// - K2-q8 (spmm_block_q8 / spmm_block_offset_q8 / spmm_split_q8, :460-516,
//   the overflow level at :486):
//   h = (sum_e bf16(q[col_e, f] * bf16(v_e))) * scale[f], f32 sum. The
//   product of two bf16 values is exact in f32, so rounding it once equals
//   JAX's bf16 multiply.
// - K2-q8mxu (spmm_block_q8mxu / spmm_block_offset_q8mxu /
//   spmm_split_q8mxu, :555-616, the overflow level at :585):
//   isum = sum_e q[col_e, f] in int32 (exact, the int8 MXU matmul's job on
//   the TPU), then
//   h = (float(isum) * row_val[r]) * scale[f] in JAX's order; the edge
//   values are not read (the operator's rows are constant).
//
// Both hops then apply the fused power-iteration update of csr_hop.cuh
// (y = scale_hop * h, acc += y) to f32 or bf16 carries.
//
// What bounds them on an H100: bytes. quantize must read x once and write
// q (5 bytes an element for f32 x); quantize_with_amax alone does just
// that, and column_absmax reads x a second time at the first hop.
// A hop must read q (1 byte an element instead of 4), the CSR structure and
// acc, and write y and acc: at the Amazon2M stand-in's [2M, 100], nnz 8.9M,
// about 2.65 GB (q8mxu) and 2.69 GB (q8) with f32 carries, against 3.28 GB
// for K2. Of that, the carries (acc read and written, y written) are 2.4 GB.
// The gathers read nnz rows of q, not n: 0.89 GB at F 100, 1.14 GB counted
// as the 32-byte sectors they touch. Measured on an H100 (chip_smoke.py's
// phase 3d, PERF.md), the carries alone stream at about 3.1 TB/s and q's
// rows gathered alone come at about 1.3 TB/s (100 random bytes a row), and
// the hop takes about the sum of the two: the HBM's rate on random short
// rows, not the kernel's latency or issue, is what holds it. Nothing
// here is bound by operations (a term is a byte permute and an add, or for
// K2-q8 a byte permute, a subtract, a multiply, a bf16 rounding and an
// add). The quantize passes read x four elements a load where F and x's
// alignment allow.
//
// The design (one template for both hops, csr_spmm_q8_hop_kernel):
// - A group of G lanes (a power of two up to 32) takes one row, so a warp
//   holds 32/G rows where F is narrow. Each lane owns NPER vectors of V
//   neighbouring int8 features, lanes side by side, read with one 16-, 8-,
//   4-, 2- or 1-byte load a vector: the widest V that F and the arrays'
//   alignment allow (F 128: 16; F 100, whose q rows are only 4-byte
//   aligned: 4; 602: 2; a misaligned view: 1). Where F needs more than
//   G * NPER * V features the row's edges are walked once per tile.
// - U edges at a time (8; 4 at V 16, the same 64 bytes a lane): their
//   column ids (and, for K2-q8, values) are loaded, then all U * NPER
//   gathers are issued before any term is added. An int8 vector costs a
//   lane one to four registers, so a lane keeps U gathers in flight instead
//   of a chain of dependent index and row loads; a row shorter than U (the
//   stand-in's rows average 4.4 nonzeros) issues all its gathers at once,
//   and only its own edges' terms are added. MINB blocks an SM caps the
//   registers so that enough warps stay resident. pick_config chooses
//   (G, V, NPER, U, MINB) from F and the alignment; csr_spmm_q8_config
//   reports its choice.
// - The terms are added in edge order, K2-q8's f32 sum as its plain
//   version's (__fadd_rn of the rounded product: no FMA contraction), and
//   K2-q8mxu's int32 sum exactly; both from biased bytes (below).
// - acc is read at the start of a row, so its latency overlaps the
//   gathers', and acc and y are read and written with the evict-first hint
//   (csr_hop.cuh's load_carries/store_update: the streamed carries), which
//   leaves the L2 to the gathered rows of q.
// - The column maxima (amax_bits given): after the gathers, each group
//   writes |y| as stored into a table of the block's rows in shared
//   memory; after a barrier, thread k takes feature k's max over the rows
//   and issues an atomicMax only where it is above the word it read from
//   the L2 earlier in the tile (the words only grow, so after the first
//   blocks almost none issue one), in place of 125,000 blocks' atomics on
//   each of F words. K2-q8mxu reads the words before its gathers, so the
//   read's latency hides behind theirs; K2-q8, whose gather loop has no
//   register to spare, reads them after. Timed on an H100, a
//   shuffle-and-atomics reduce and a flush by the block's last warp alone
//   ran slower. Without amax_bits the epilogue is compiled away (a kernel
//   of its own).
//
// Hub rows (grandtpu's spmm_block_offset_q8 / _q8mxu, the overflow level of
// SplitCSR): one group walking a row of 15,000 gathers would finish long
// after the rest of the hop, so a row with more than `cap` nonzeros is cut
// by the operator's split plan (sparse/spmm.py::SplitPlan) into chunks of
// at most cap edges, as K2's are (csr_spmm.cu). The grid's first items are
// the chunks, then the rows; a split row's own item returns. A chunk's group
// sums its edges as a row's would and writes the sum before any scale to
// the caller's [chunks, F] scratch: f32 for K2-q8, int32 for K2-q8mxu. The
// group that finishes a split row's last chunk (an integer counter a split
// row, no float atomics) adds the row's partials in chunk order, then
// applies the column scale (and the row value) and the update, in the same
// launch. K2-q8mxu's partials are int32 so that the split hop equals the
// unsplit one bit for bit: integer addition does not depend on grouping
// (the sum of a row stays exact while it has fewer than 2^31 / 127 edges).
// K2-q8's f32 partials make the split row's sum a different grouping of
// the same terms, which its plain version repeats. Rows under the cap keep
// the unsplit code and order. What bounds the split: the chunks' groups
// gather at most cap rows each, so the hop's tail is one chunk, not one
// hub row; the scratch adds chunks x F x 4 bytes written and read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "csr_hop.cuh"

namespace {

using grandtpu::round_bf16;

constexpr int kMaxRowBlocks = 2048;

// Column maxima of |x|: thread (tx, ty) of a block takes columns
// [c * kVec, c * kVec + kVec), c = blockIdx.x * 32 + tx, over every 8th row
// of the block's row range; the block reduces over ty, then atomicMax.
template <typename T, int kVec>
__global__ void column_absmax_kernel(const T* __restrict__ x,
                                     unsigned int* __restrict__ amax_bits,
                                     int num_rows, int num_features,
                                     int rows_per_block) {
  __shared__ float part[8][32 * kVec + 1];
  const int f0 = (blockIdx.x * 32 + threadIdx.x) * kVec;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < num_rows ? r0 + rows_per_block
                                                     : num_rows;
  float m[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) m[j] = 0.0f;
  if (f0 < num_features) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float v[kVec];
      grandtpu::load_x(x + r * num_features + f0, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) m[j] = fmaxf(m[j], fabsf(v[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    part[threadIdx.y][threadIdx.x * kVec + j] = m[j];
  }
  __syncthreads();
  if (threadIdx.y == 0 && f0 < num_features) {
    for (int k = 1; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        m[j] = fmaxf(m[j], part[k][threadIdx.x * kVec + j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      atomicMax(amax_bits + f0 + j, __float_as_uint(m[j]));
    }
  }
}

using grandtpu::quantize_one;

__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&v)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
}

// Features a quantize block's shared scales cover: a column window.
constexpr int kScaleWindow = 4096;

// quantize_with_amax in one launch: q = clamp(rint(x / scale)). A block
// takes the column window blockIdx.y (kScaleWindow features) and first
// computes the window's scales from amax into shared memory (the blocks of
// grid column 0 also write them to col_scale and zero the caller's next
// amax buffer, if any); then each thread takes groups of kVec neighbouring
// elements of the window, grid-stride over its rows, its column advancing
// by the stride modulo the window's groups (no 64-bit division per
// element).
template <typename T, int kVec>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const unsigned int* __restrict__ amax_bits,
                                int8_t* __restrict__ q,
                                float* __restrict__ col_scale,
                                unsigned int* __restrict__ zero_bits,
                                int num_rows, int num_features,
                                int scale_bf16) {
  __shared__ float scales[kScaleWindow];
  const int f0 = blockIdx.y * kScaleWindow;
  const int width = num_features - f0 < kScaleWindow ? num_features - f0
                                                     : kScaleWindow;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    const float amax = __uint_as_float(amax_bits[f0 + k]);
    const float scale = grandtpu::column_scale(amax);
    scales[k] = scale_bf16 && amax > 0.0f ? round_bf16(scale) : scale;
    if (blockIdx.x == 0) {
      col_scale[f0 + k] = scales[k];
      if (zero_bits != nullptr) zero_bits[f0 + k] = 0u;
    }
  }
  __syncthreads();
  const int groups = width / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  int64_t r = g / groups;
  int col = static_cast<int>(g % groups);
  const int64_t row_step = stride / groups;
  const int col_step = static_cast<int>(stride % groups);
  while (r < num_rows) {
    const int64_t i = r * num_features + f0 + col * kVec;
    float v[kVec];
    grandtpu::load_x(x + i, v);
    int8_t out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out[j] = quantize_one(v[j], scales[col * kVec + j]);
    }
    store_q(q + i, out);
    r += row_step;
    col += col_step;
    if (col >= groups) {
      col -= groups;
      ++r;
    }
  }
}

using grandtpu::Split;

// --- the two hops: one template ---------------------------------------

constexpr int kThreads = 256;

// The 32-bit words that hold one vector of V int8 features.
__host__ __device__ constexpr int vec_words(int v) {
  return v >= 4 ? v / 4 : 1;
}

// One vector of V neighbouring int8 features of a gathered row, as raw
// words: one 16-, 8-, 4-, 2- or 1-byte load (p aligned to V bytes).
template <int V>
__device__ __forceinline__ void load_qvec(const int8_t* p,
                                          unsigned int (&w)[vec_words(V)]) {
  if constexpr (V == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  } else if constexpr (V == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x;
    w[1] = t.y;
  } else if constexpr (V == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (V == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

// The int8 terms work on biased bytes: b = q ^ 0x80 = q + 128 in [1, 255]
// (a word's four at once, one XOR), so that one byte permute makes a term
// from byte j of a biased word: as an int (K2-q8mxu, whose sum then takes
// 128 for each edge away), or as the float 1.5 * 2^23 + b, whose ulp is 1,
// from which (1.5 * 2^23 + 128) is taken exactly (K2-q8), with no I2F (a
// quarter-rate instruction).
constexpr unsigned int kBias = 0x80808080u;

__device__ __forceinline__ int biased_byte(unsigned int wb, int j) {
  return static_cast<int>(__byte_perm(wb, 0u, 0x4440u | j));
}

__device__ __forceinline__ float byte_to_float(unsigned int wb, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(wb, 0x4b400000u, 0x7640u | j)),
                   12583040.0f);
}

// V column scales at col_scale + f (aligned to V floats or 16 bytes).
template <int V>
__device__ __forceinline__ void load_scales(const float* p, float (&cs)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      float t[4];
      grandtpu::load_x(p + 4 * k, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[4 * k + j] = t[j];
    }
  } else {
    grandtpu::load_x(p, cs);
  }
}

// h of one output from its sum: K2-q8mxu (float(isum) * row_val) *
// col_scale in JAX's order; K2-q8 sum * col_scale.
template <bool kMxu, typename S>
__device__ __forceinline__ float scaled(S sum, float rv, float cs) {
  if constexpr (kMxu) {
    return __fmul_rn(__fmul_rn(__int2float_rn(sum), rv), cs);
  } else {
    return __fmul_rn(sum, cs);
  }
}

// The widest tile of features a group walks: lanes * NPER * V of every
// configuration of pick_config (32 lanes of one 16-byte vector); a thread
// of the block flushes at most kMaxTile / kThreads of a tile's maxima.
constexpr int kMaxTile = 512;
constexpr int kFlush = kMaxTile / kThreads;

// The maxima amax[f_tile + k] that thread k (and k + kThreads) flushes
// for the tile, as they stand now (ld.global.cg: the L2's value).
__device__ __forceinline__ void read_maxima(const unsigned int* amax,
                                            int f_tile, int tile, int F,
                                            unsigned int (&seen)[kFlush]) {
#pragma unroll
  for (int i = 0; i < kFlush; ++i) {
    const int k = threadIdx.x + i * kThreads;
    seen[i] = k < tile && f_tile + k < F ? __ldcg(amax + f_tile + k) : 0u;
  }
}

// |y| of one vector of V features into the block's table of stored
// values (16-byte stores where V allows).
template <int V>
__device__ __forceinline__ void put_abs(float* p, const float (&v)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(fabsf(v[k]), fabsf(v[k + 1]), fabsf(v[k + 2]),
                      fabsf(v[k + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = fabsf(v[j]);
  }
}

// One int8 hop. kMxu: K2-q8mxu (int32 sums; edge = row_val [n]); else
// K2-q8 (f32 sums of bf16-rounded terms; edge = the edge values [nnz]).
// A group of `lanes` lanes takes one work item (hop_item: the plan's
// chunks, then the rows); lane g owns NPER vectors of V features of each
// tile of lanes * NPER * V features, vector p at features
// f_tile + (p * lanes + g) * V. The row's edges are walked U at a time:
// U column ids (and values) loaded, then all U * NPER gathers issued, then
// the terms added in edge order. A batch past the row's end loads nothing
// and adds zero terms, which leave the sums as they are (an f32 sum that
// starts at +0 is never -0, and s + +0 = s).
//
// kAmax: the hop also raises amax[f] to max |y[:, f]| of the y it stores
// (the next hop's quantize reads it in place of a pass over y). Each
// group writes |y| of its tile into the block's table in shared memory
// (one row a group; zeros where it stored nothing), and after a barrier
// thread k takes the max of feature k over the block's rows and raises
// amax[f] with an atomic only where that max is above the value it read
// (ld.global.cg) at the tile's start, before the gathers: the words only
// grow, so the read's latency hides behind the gathers' and most blocks
// issue no atomic. A split row's finishing group raises amax directly.
// Every thread of the block stays to the end for the barriers, so a
// thread without an item runs the tiles with no edges and stores
// nothing.
template <bool kMxu, bool kAmax, int V, int NPER, int U, int MINB,
          typename T>
__global__ void __launch_bounds__(kThreads, MINB)
csr_spmm_q8_hop_kernel(const int32_t* __restrict__ indptr,
                       const int32_t* __restrict__ indices,
                       const float* __restrict__ edge,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ col_scale,
                       T* __restrict__ y, T* __restrict__ acc,
                       unsigned int* __restrict__ amax, int num_rows,
                       int num_features, float scale, int accumulate,
                       int lanes, int log_lanes, Split split) {
  using S = std::conditional_t<kMxu, int, float>;
  constexpr int W = vec_words(V);
  // kAmax: |y| of the tile, a row of `tile` floats for each group
  __shared__ __align__(16) float block_y[kAmax ? kThreads * NPER * V : 1];
  const int g = threadIdx.x & (lanes - 1);
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
      log_lanes;
  int64_t row = 0;
  int lo = 0, hi = 0;
  const bool have =
      grandtpu::hop_item(indptr, num_rows, split, item, row, lo, hi);
  if constexpr (kAmax) {
    if (!have) row = lo = hi = 0;
  } else {
    if (!have) return;
  }
  const bool is_chunk = item < split.num_chunks;
  const bool stores = have && !is_chunk;
  const bool load_acc = stores && accumulate;
  S* partial = static_cast<S*>(split.partial);
  const int F = num_features;
  const int64_t out = row * F;
  const float rv = kMxu && have ? __ldg(edge + row) : 0.0f;
  const int tile = lanes * NPER * V;
  for (int f_tile = 0; f_tile < F; f_tile += tile) {
    // the maxima this thread flushes, as they stand now: read before the
    // gathers by K2-q8mxu, after them by K2-q8, which has no register to
    // spare across its gather loop
    unsigned int seen[kAmax ? kFlush : 1];
    if constexpr (kAmax && kMxu) read_maxima(amax, f_tile, tile, F, seen);
    // acc's values first: their loads are in flight with the gathers
    float a[NPER][V];
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
      const int f = f_tile + (p * lanes + g) * V;
      if (load_acc && f < F) {
        grandtpu::load_carries(acc + out + f, a[p]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) a[p][j] = 0.0f;
      }
    }
    S s[NPER][V];
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
#pragma unroll
      for (int j = 0; j < V; ++j) s[p][j] = 0;
    }
    for (int e = lo; e < hi; e += U) {
      const int left = hi - e;
      int c[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = u < left ? __ldg(indices + e + u) : 0;
        if constexpr (!kMxu) {
          v[u] = u < left ? round_bf16(__ldg(edge + e + u)) : 0.0f;
        }
      }
      unsigned int w[U][NPER][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
          const int f = f_tile + (p * lanes + g) * V;
          if (u < left && f < F) {
            load_qvec<V>(q + static_cast<int64_t>(c[u]) * F + f, w[u][p]);
          } else {
#pragma unroll
            for (int k = 0; k < W; ++k) w[u][p][k] = 0u;
          }
        }
      }
      // the terms of the batch's edges in edge order; none past the row's
      // end
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= left) break;
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const unsigned int wb = w[u][p][k] ^ kBias;
#pragma unroll
            for (int j = 4 * k; j < 4 * k + 4 && j < V; ++j) {
              if constexpr (kMxu) {
                s[p][j] += biased_byte(wb, j - 4 * k);
              } else {
                // bf16(q * bf16(v)): the product of two bf16 values is
                // exact in f32, so rounding it once is JAX's bf16 multiply
                s[p][j] = __fadd_rn(s[p][j], round_bf16(__fmul_rn(
                                        byte_to_float(wb, j - 4 * k), v[u])));
              }
            }
          }
        }
      }
    }
    if constexpr (kMxu) {
      // the bias of the row's (or chunk's) edges
#pragma unroll
      for (int p = 0; p < NPER; ++p) {
#pragma unroll
        for (int j = 0; j < V; ++j) s[p][j] -= 128 * (hi - lo);
      }
    }
    if constexpr (kAmax && !kMxu) read_maxima(amax, f_tile, tile, F, seen);
    if constexpr (!kAmax) {
      // (the loop of the hop without the maxima, kept in this form: the
      // one below costs K2-q8 a spill and 3 % at F 100)
#pragma unroll
      for (int p = 0; p < NPER; ++p) {
        const int f = f_tile + (p * lanes + g) * V;
        if (f >= F) continue;
        if (is_chunk) {
          // the chunk's sums before any scale
#pragma unroll
          for (int j = 0; j < V; ++j) partial[item * F + f + j] = s[p][j];
          continue;
        }
        float cs[V], h[V], stored[V];
        load_scales<V>(col_scale + f, cs);
#pragma unroll
        for (int j = 0; j < V; ++j) h[j] = scaled<kMxu>(s[p][j], rv, cs[j]);
        grandtpu::store_update(h, a[p], scale, y, acc, out + f, accumulate,
                               stored);
      }
    } else {
#pragma unroll
      for (int p = 0; p < NPER; ++p) {
        const int f = f_tile + (p * lanes + g) * V;
        float stored[V];
#pragma unroll
        for (int j = 0; j < V; ++j) stored[j] = 0.0f;
        if (have && f < F) {
          if (is_chunk) {
#pragma unroll
            for (int j = 0; j < V; ++j) partial[item * F + f + j] = s[p][j];
          } else {
            float cs[V], h[V];
            load_scales<V>(col_scale + f, cs);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              h[j] = scaled<kMxu>(s[p][j], rv, cs[j]);
            }
            grandtpu::store_update(h, a[p], scale, y, acc, out + f,
                                   accumulate, stored);
          }
        }
        put_abs<V>(block_y + (threadIdx.x >> log_lanes) * tile +
                       (p * lanes + g) * V,
                   stored);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kFlush; ++i) {
        const int k = threadIdx.x + i * kThreads;
        if (k < tile && f_tile + k < F) {
          float m = 0.0f;
          for (int r = 0; r < kThreads >> log_lanes; ++r) {
            m = fmaxf(m, block_y[r * tile + k]);
          }
          if (__float_as_uint(m) > seen[i]) {
            atomicMax(amax + f_tile + k, __float_as_uint(m));
          }
        }
      }
      // the next tile writes the table again
      if (f_tile + tile < F) __syncthreads();
    }
  }
  if (!have || !is_chunk || !grandtpu::last_chunk(split, item, lanes)) {
    return;
  }
  // the group that finished the split row's last chunk adds the row's
  // partials in chunk order (int32: exact in any order), then the scales
  const int i = split.chunk_row[item];
  const int c0 = split.chunk_ptr[i];
  const int c1 = split.chunk_ptr[i + 1];
  for (int f = g; f < F; f += lanes) {
    S t = 0;
    for (int c = c0; c < c1; ++c) {
      const S part = __ldcg(partial + static_cast<int64_t>(c) * F + f);
      if constexpr (kMxu) {
        t += part;
      } else {
        t = __fadd_rn(t, part);
      }
    }
    float h[1] = {scaled<kMxu>(t, rv, __ldg(col_scale + f))};
    float a[1] = {0.0f};
    float stored[1];
    if (accumulate) grandtpu::load_carries(acc + out + f, a);
    grandtpu::store_update(h, a, scale, y, acc, out + f, accumulate, stored);
    if constexpr (kAmax) {
      // (the words only grow: an atomic only where it would raise one)
      const unsigned int m = __float_as_uint(fabsf(stored[0]));
      if (m > __ldcg(amax + f)) atomicMax(amax + f, m);
    }
  }
}

template <typename T, int kVec>
int absmax(const void* x, unsigned int* amax_bits, int num_rows,
           int num_features, cudaStream_t stream) {
  const int per_block = (num_rows + kMaxRowBlocks - 1) / kMaxRowBlocks;
  const int rows_per_block = per_block > 8 ? per_block : 8;
  const dim3 grid((num_features + 32 * kVec - 1) / (32 * kVec),
                  (num_rows + rows_per_block - 1) / rows_per_block);
  column_absmax_kernel<T, kVec><<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(x), amax_bits, num_rows, num_features,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int quantize(const void* x, const unsigned int* amax_bits, int8_t* q,
             float* col_scale, unsigned int* zero_bits, int num_rows,
             int num_features, int scale_bf16, cudaStream_t stream) {
  const int windows = (num_features + kScaleWindow - 1) / kScaleWindow;
  const int per_row = num_features < kScaleWindow ? num_features
                                                  : kScaleWindow;
  const int64_t groups = static_cast<int64_t>(num_rows) * (per_row / kVec);
  const int64_t want = (groups + 255) / 256;
  const int64_t blocks = want < 132 * 16 ? want : 132 * 16;
  quantize_kernel<T, kVec>
      <<<dim3(static_cast<unsigned int>(blocks), windows), 256, 0, stream>>>(
          static_cast<const T*>(x), amax_bits, q, col_scale, zero_bits,
          num_rows, num_features, scale_bf16);
  return static_cast<int>(cudaGetLastError());
}


// A launch configuration: `lanes` lanes a row, V features a vector (16,
// 8, 4, 2 or 1 bytes of q), NPER vectors a lane, U edges gathered before
// their terms are added, MINB blocks of kThreads an SM (the register
// budget: 65,536 / (MINB * 256) registers a thread).
struct Config {
  int lanes, v, nper, u, minb;
};

// The widest vector that F and the alignment allow (align_bytes: the
// features every array can take as one aligned vector, hop_align), then
// that width's (NPER, U, MINB), then the fewest lanes (a power of two up
// to 32) whose NPER vectors cover F. V 4 and 16 were chosen by timing
// configurations on an H100 at F 100 (the Amazon2M stand-in) and 128
// (the skew graph), each against its plain version: 4 blocks an SM (64
// registers) beat 5 to 8 (spills) and 2 to 3, and at V 16 four edges a
// batch (64 bytes a lane in flight, as V 4's 2 x 8 words) beat eight at
// fewer blocks and two. K2-q8 at V 16 spills about 50 bytes there, and
// still beat the configurations without spills (3 blocks, or U 2). V 8, 2
// and 1 take the same budget without spills (V 1 at 3 blocks: K2-q8
// spills at 4). sparse/spmm.py::q8_hop_config mirrors it.
Config pick_config(int num_features, int align_bytes) {
  int v = 16;
  while (v > 1 && (num_features % v != 0 || align_bytes % v != 0)) v /= 2;
  Config c = v == 16  ? Config{0, 16, 1, 4, 4}
             : v == 8 ? Config{0, 8, 1, 8, 4}
             : v == 4 ? Config{0, 4, 2, 8, 4}
             : v == 2 ? Config{0, 2, 2, 8, 4}
                      : Config{0, 1, 4, 8, 3};
  const int vecs = (num_features + v - 1) / v;
  c.lanes = 1;
  while (c.lanes < 32 && c.lanes * c.nper < vecs) c.lanes *= 2;
  return c;
}

#define Q8_CONFIGS(X) \
  X(16, 1, 4, 4) X(8, 1, 8, 4) X(4, 2, 8, 4) X(2, 2, 8, 4) X(1, 4, 8, 3)

// The features that q, col_scale, y and acc all take as one aligned vector
// (16 at most): q aligned to that many bytes, the carries and the scales
// to that many elements or 16 bytes.
int hop_align(const int8_t* q, const float* col_scale, const void* y,
              const void* acc, int carry_bytes) {
  for (int v = 16; v > 1; v /= 2) {
    const unsigned int cb = v * carry_bytes < 16 ? v * carry_bytes : 16;
    const unsigned int sb = v * 4 < 16 ? v * 4 : 16;
    if (grandtpu::aligned(q, v) && grandtpu::aligned(col_scale, sb) &&
        grandtpu::aligned(y, cb) &&
        (acc == nullptr || grandtpu::aligned(acc, cb))) {
      return v;
    }
  }
  return 1;
}

// The kernel's arguments, as the entry points take them.
struct HopArgs {
  const int32_t* indptr;
  const int32_t* indices;
  const float* edge;
  const int8_t* q;
  const float* col_scale;
  void* y;
  void* acc;
  unsigned int* amax;   // null: the hop takes no column maxima
  int num_rows, num_features;
  float scale;
  int accumulate;
  Split split;
};

template <bool kMxu, int V, int NPER, int U, int MINB, typename T>
int launch_kernel(const HopArgs& a, int lanes, cudaStream_t stream) {
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes) ++log_lanes;
  const int64_t threads =
      (static_cast<int64_t>(a.split.num_chunks) + a.num_rows) * lanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = a.amax != nullptr
      ? csr_spmm_q8_hop_kernel<kMxu, true, V, NPER, U, MINB, T>
      : csr_spmm_q8_hop_kernel<kMxu, false, V, NPER, U, MINB, T>;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      a.indptr, a.indices, a.edge, a.q, a.col_scale, static_cast<T*>(a.y),
      static_cast<T*>(a.acc), a.amax, a.num_rows, a.num_features, a.scale,
      a.accumulate, lanes, log_lanes, a.split);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMxu, typename T>
int launch(const HopArgs& a, const Config& c, cudaStream_t stream) {
#define Q8_PICK(V, N, U, M)                                              \
  if (c.v == V && c.nper == N && c.u == U && c.minb == M) {              \
    return launch_kernel<kMxu, V, N, U, M, T>(a, c.lanes, stream);      \
  }
  Q8_CONFIGS(Q8_PICK)
#undef Q8_PICK
  return static_cast<int>(cudaErrorInvalidValue);
}

// The two hops' entry: the plan's arguments as csr_spmm_prop's
// (csr_spmm.cu), partial f32 (K2-q8) or int32 (K2-q8mxu).
template <bool kMxu>
int hop(const int32_t* indptr, const int32_t* indices, const float* edge,
        const int8_t* q, const float* col_scale, void* y, void* acc,
        unsigned int* amax, int num_rows, int num_features, float scale,
        int accumulate, int carry_bf16, const int32_t* split_rows,
        const int32_t* chunk_ptr, const int32_t* chunk_row,
        const int32_t* chunk_lo, int num_chunks, int cap, void* partial,
        int* counters, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  if (num_chunks > 0 && cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HopArgs a{indptr, indices, edge, q, col_scale, y,
                  accumulate ? acc : nullptr, amax, num_rows, num_features,
                  scale, accumulate,
                  Split{split_rows, chunk_ptr, chunk_row, chunk_lo,
                        num_chunks, num_chunks ? cap : 0x7fffffff, partial,
                        counters}};
  const Config c = pick_config(
      num_features, hop_align(q, col_scale, y, a.acc, carry_bf16 ? 2 : 4));
  auto s = static_cast<cudaStream_t>(stream);
  return carry_bf16 ? launch<kMxu, __nv_bfloat16>(a, c, s)
                    : launch<kMxu, float>(a, c, s);
}

}  // namespace

// Each returns the cudaError_t of its launches (0 on success).

// The quantize in two entry points, so that a row-partitioned caller can
// take the max of the shards' column maxima between them (grandtpu's
// lax.pmax, dist/spmm_shard.py:341-344).
//
// column_absmax: x [n, F] f32 (x_bf16 = 0) or bf16; amax_bits [F] zeroed
// by the caller, gets max |x[:, f]| as float bits. n must be > 0.
extern "C" int column_absmax(const void* x, unsigned int* amax_bits,
                             int num_rows, int num_features, int x_bf16,
                             void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = grandtpu::carries_vec4(num_features, x, x_bf16);
  if (x_bf16) {
    return vec4 ? absmax<__nv_bfloat16, 4>(x, amax_bits, num_rows,
                                           num_features, s)
                : absmax<__nv_bfloat16, 1>(x, amax_bits, num_rows,
                                           num_features, s);
  }
  return vec4 ? absmax<float, 4>(x, amax_bits, num_rows, num_features, s)
              : absmax<float, 1>(x, amax_bits, num_rows, num_features, s);
}

// quantize_with_amax, one launch: the F column scales from amax_bits
// (rounded to bf16 for bf16 x), then q [n, F] int8; writes q and
// col_scale [F] f32, and zeroes zero_bits [F] (null: none), the amax
// buffer that the next hop raises, which must not be amax_bits.
extern "C" int quantize_with_amax(const void* x, const unsigned int* amax_bits,
                                  int8_t* q, float* col_scale,
                                  unsigned int* zero_bits, int num_rows,
                                  int num_features, int x_bf16, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = grandtpu::carries_vec4(num_features, x, x_bf16) &&
                    grandtpu::aligned(q, 4);
  if (x_bf16) {
    return vec4 ? quantize<__nv_bfloat16, 4>(x, amax_bits, q, col_scale,
                                             zero_bits, num_rows,
                                             num_features, 1, s)
                : quantize<__nv_bfloat16, 1>(x, amax_bits, q, col_scale,
                                             zero_bits, num_rows,
                                             num_features, 1, s);
  }
  return vec4 ? quantize<float, 4>(x, amax_bits, q, col_scale, zero_bits,
                                   num_rows, num_features, 0, s)
              : quantize<float, 1>(x, amax_bits, q, col_scale, zero_bits,
                                   num_rows, num_features, 0, s);
}

// y, acc [n, F] f32 (carry_bf16 = 0) or bf16, acc may be null when
// accumulate is 0; with bf16 carries scale must already be a bf16 value.
// amax_bits [F] (null: none) is raised to max |y[:, f]| of the y stored,
// as float bits (zero it before the launch to get the hop's own maxima).
// The split plan (num_chunks = 0: none): the split rows (ascending), each
// one's chunks chunk_ptr[i] : chunk_ptr[i + 1], each chunk's split-row
// index and first edge, the cap; partial is f32 [num_chunks, num_features]
// scratch and counters int32 [split rows], zero before the launch.
extern "C" int csr_spmm_q8(const int32_t* indptr, const int32_t* indices,
                           const float* values, const int8_t* q,
                           const float* col_scale, void* y, void* acc,
                           unsigned int* amax_bits, int num_rows,
                           int num_features, float scale, int accumulate,
                           int carry_bf16, const int32_t* split_rows,
                           const int32_t* chunk_ptr, const int32_t* chunk_row,
                           const int32_t* chunk_lo, int num_chunks, int cap,
                           float* partial, int* counters, void* stream) {
  return hop<false>(indptr, indices, values, q, col_scale, y, acc, amax_bits,
                    num_rows, num_features, scale, accumulate, carry_bf16,
                    split_rows, chunk_ptr, chunk_row, chunk_lo, num_chunks,
                    cap, partial, counters, stream);
}

// As csr_spmm_q8, with row_val [n] f32 in place of the edge values and
// partial int32 [num_chunks, num_features].
extern "C" int csr_spmm_q8mxu(const int32_t* indptr, const int32_t* indices,
                              const float* row_val, const int8_t* q,
                              const float* col_scale, void* y, void* acc,
                              unsigned int* amax_bits, int num_rows,
                              int num_features, float scale, int accumulate,
                              int carry_bf16, const int32_t* split_rows,
                              const int32_t* chunk_ptr,
                              const int32_t* chunk_row,
                              const int32_t* chunk_lo, int num_chunks,
                              int cap, int* partial, int* counters,
                              void* stream) {
  return hop<true>(indptr, indices, row_val, q, col_scale, y, acc, amax_bits,
                   num_rows, num_features, scale, accumulate, carry_bf16,
                   split_rows, chunk_ptr, chunk_row, chunk_lo, num_chunks,
                   cap, partial, counters, stream);
}

// The features that the hops take as one aligned vector of these arrays
// (hop_align; carry_bf16 as the hops'), the align_bytes of
// csr_spmm_q8_config. The pointers are not read.
extern "C" int csr_spmm_q8_align(const void* q, const void* col_scale,
                                 const void* y, const void* acc,
                                 int carry_bf16) {
  return hop_align(static_cast<const int8_t*>(q),
                   static_cast<const float*>(col_scale), y, acc,
                   carry_bf16 ? 2 : 4);
}

// The launch configuration the hops pick for F features when the arrays
// take `align_bytes` features as one aligned vector (hop_align: 16 for
// fresh allocations): out[0..4] = lanes a row, V, NPER, U, MINB.
extern "C" int csr_spmm_q8_config(int num_features, int align_bytes,
                                  int* out) {
  if (num_features < 1 || align_bytes < 1 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Config c = pick_config(num_features, align_bytes);
  out[0] = c.lanes;
  out[1] = c.v;
  out[2] = c.nper;
  out[3] = c.u;
  out[4] = c.minb;
  return 0;
}
