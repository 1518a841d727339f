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
//   Three launches behind two entry points: column_absmax, a column-max
//   reduction (per-block partial maxima, then atomicMax on the float bits,
//   which orders non-negative floats); quantize_with_amax, the F column
//   scales, then the elementwise quantize. The row-partitioned int8
//   propagation (grandtpu/dist/spmm_shard.py:341-344) takes the max of the
//   shards' maxima between the two.
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
// q (5 bytes an element for f32 x; the two passes really read x twice).
// A hop must read q (1 byte an element instead of 4), the CSR structure and
// acc, and write y and acc: at the Amazon2M stand-in's [2M, 100], nnz 8.9M,
// about 2.65 GB (q8mxu) and 2.69 GB (q8) with f32 carries, against 3.28 GB
// for K2. The design is one warp per row with the update fused; where F is
// a multiple of 4 (and the arrays aligned to it) each lane takes 4
// neighbouring features: one 32-bit load of int8 per gathered row, one
// vector load and store of acc and y, so one pass of a warp covers 128
// features. The quantize passes read x 4 elements a load the same way.
//
// Hub rows (grandtpu's spmm_block_offset_q8 / _q8mxu, the overflow level of
// SplitCSR): one warp walking a row of 15,000 gathers would finish long
// after the rest of the hop, so a row with more than `cap` nonzeros is cut
// by the operator's split plan (sparse/spmm.py::SplitPlan) into chunks of
// at most cap edges, as K2's are (csr_spmm.cu). The grid's first items are
// the chunks, then the rows; a split row's own item returns. A chunk's warp
// sums its edges as a row's would and writes the sum before any scale to
// the caller's [chunks, F] scratch: f32 for K2-q8, int32 for K2-q8mxu. The
// warp that finishes a split row's last chunk (an integer counter a split
// row, no float atomics) adds the row's partials in chunk order, then
// applies the column scale (and the row value) and the update, in the same
// launch. K2-q8mxu's partials are int32 so that the split hop equals the
// unsplit one bit for bit: integer addition does not depend on grouping
// (the sum of a row stays exact while it has fewer than 2^31 / 127 edges).
// K2-q8's f32 partials make the split row's sum a different grouping of
// the same terms, which its plain version repeats. Rows under the cap keep
// the unsplit code and order. What bounds the split: the chunks' warps
// gather at most cap rows each, so the hop's tail is one chunk, not one
// hub row; the scratch adds chunks x F x 4 bytes written and read once.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void column_scale_kernel(const unsigned int* __restrict__ amax_bits,
                                    float* __restrict__ col_scale,
                                    int num_features, int scale_bf16) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= num_features) return;
  const float amax = __uint_as_float(amax_bits[f]);
  const float scale = grandtpu::column_scale(amax);
  col_scale[f] = scale_bf16 && amax > 0.0f ? round_bf16(scale) : scale;
}

using grandtpu::load_q;
using grandtpu::quantize_one;

__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&v)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
}

// q = clamp(rint(x / scale)): each thread takes groups of kVec neighbouring
// elements, grid-stride; its column advances by the stride modulo the
// groups in a row, so no 64-bit division per element.
template <typename T, int kVec>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ col_scale,
                                int8_t* __restrict__ q, int64_t groups,
                                int groups_per_row) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int col = static_cast<int>(g % groups_per_row);
  const int col_step = static_cast<int>(stride % groups_per_row);
  for (; g < groups; g += stride) {
    float v[kVec];
    grandtpu::load_x(x + g * kVec, v);
    int8_t out[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out[j] = quantize_one(v[j], __ldg(col_scale + col * kVec + j));
    }
    store_q(q + g * kVec, out);
    col += col_step;
    if (col >= groups_per_row) col -= groups_per_row;
  }
}

using grandtpu::Split;

// The work item of one warp (grandtpu::hop_item).
__device__ __forceinline__ bool warp_item(const int32_t* __restrict__ indptr,
                                          int num_rows, const Split& s,
                                          int64_t& item, int64_t& row,
                                          int& lo, int& hi) {
  item = static_cast<int64_t>(blockIdx.x) * grandtpu::kWarpsPerBlock +
         threadIdx.x / 32;
  return grandtpu::hop_item(indptr, num_rows, s, item, row, lo, hi);
}

template <int kVec, typename T>
__global__ void csr_spmm_q8_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const float* __restrict__ values,
                                   const int8_t* __restrict__ q,
                                   const float* __restrict__ col_scale,
                                   T* __restrict__ y, T* __restrict__ acc,
                                   int num_rows, int num_features,
                                   float scale, int accumulate, Split split) {
  int64_t item, row;
  int start, end;
  if (!warp_item(indptr, num_rows, split, item, row, start, end)) return;
  const bool is_chunk = item < split.num_chunks;
  float* partial = static_cast<float*>(split.partial);
  const int lane = threadIdx.x & 31;
  const int64_t out_base = row * num_features;
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    float s[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = 0.0f;
    for (int e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      const float v = round_bf16(__ldg(values + e));
      int qv[kVec];
      load_q(q + col * num_features + f0, qv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] = __fadd_rn(s[j], round_bf16(__fmul_rn(
                                   static_cast<float>(qv[j]), v)));
      }
    }
    if (is_chunk) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        partial[item * num_features + f0 + j] = s[j];
      }
      continue;
    }
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      h[j] = __fmul_rn(s[j], __ldg(col_scale + f0 + j));
    }
    grandtpu::store_hops(h, scale, y, acc, out_base + f0, accumulate);
  }
  if (!is_chunk || !grandtpu::last_chunk(split, item)) return;
  // the row's chunk partials in chunk order, then the column scale
  const int i = split.chunk_row[item];
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = 0.0f;
    for (int c = split.chunk_ptr[i]; c < split.chunk_ptr[i + 1]; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        h[j] = __fadd_rn(h[j], __ldcg(partial + static_cast<int64_t>(c) *
                                                    num_features + f0 + j));
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      h[j] = __fmul_rn(h[j], __ldg(col_scale + f0 + j));
    }
    grandtpu::store_hops(h, scale, y, acc, out_base + f0, accumulate);
  }
}

template <int kVec, typename T>
__global__ void csr_spmm_q8mxu_kernel(const int32_t* __restrict__ indptr,
                                      const int32_t* __restrict__ indices,
                                      const float* __restrict__ row_val,
                                      const int8_t* __restrict__ q,
                                      const float* __restrict__ col_scale,
                                      T* __restrict__ y, T* __restrict__ acc,
                                      int num_rows, int num_features,
                                      float scale, int accumulate,
                                      Split split) {
  int64_t item, row;
  int start, end;
  if (!warp_item(indptr, num_rows, split, item, row, start, end)) return;
  const bool is_chunk = item < split.num_chunks;
  int* partial = static_cast<int*>(split.partial);
  const int lane = threadIdx.x & 31;
  const int64_t out_base = row * num_features;
  const float rv = __ldg(row_val + row);
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    int isum[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) isum[j] = 0;
#pragma unroll 4
    for (int e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      int qv[kVec];
      load_q(q + col * num_features + f0, qv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) isum[j] += qv[j];
    }
    if (is_chunk) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        partial[item * num_features + f0 + j] = isum[j];
      }
      continue;
    }
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      h[j] = __fmul_rn(__fmul_rn(__int2float_rn(isum[j]), rv),
                       __ldg(col_scale + f0 + j));
    }
    grandtpu::store_hops(h, scale, y, acc, out_base + f0, accumulate);
  }
  if (!is_chunk || !grandtpu::last_chunk(split, item)) return;
  // the row's int32 chunk partials (exact in any order), then the scales
  const int i = split.chunk_row[item];
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    int isum[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) isum[j] = 0;
    for (int c = split.chunk_ptr[i]; c < split.chunk_ptr[i + 1]; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        isum[j] += __ldcg(partial + static_cast<int64_t>(c) * num_features +
                          f0 + j);
      }
    }
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      h[j] = __fmul_rn(__fmul_rn(__int2float_rn(isum[j]), rv),
                       __ldg(col_scale + f0 + j));
    }
    grandtpu::store_hops(h, scale, y, acc, out_base + f0, accumulate);
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
             float* col_scale, int num_rows, int num_features, int scale_bf16,
             cudaStream_t stream) {
  column_scale_kernel<<<(num_features + 255) / 256, 256, 0, stream>>>(
      amax_bits, col_scale, num_features, scale_bf16);
  const int groups_per_row = num_features / kVec;
  const int64_t groups = static_cast<int64_t>(num_rows) * groups_per_row;
  const int64_t want = (groups + 255) / 256;
  const int64_t blocks = want < 132 * 16 ? want : 132 * 16;
  quantize_kernel<T, kVec><<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(x), col_scale, q, groups, groups_per_row);
  return static_cast<int>(cudaGetLastError());
}

// Whether a hop can take 4 neighbouring features a lane: F a multiple of 4
// and q, col_scale, y and acc aligned to 4 elements (then so is every row).
bool hop_vec4(int num_features, const int8_t* q, const float* col_scale,
              const void* y, const void* acc, int carry_bf16) {
  return grandtpu::carries_vec4(num_features, y, carry_bf16) &&
         grandtpu::carries_vec4(num_features, acc, carry_bf16) &&
         grandtpu::aligned(q, 4) && grandtpu::aligned(col_scale, 16);
}

// Launches K2-q8mxu (kMxu; edge = row_val [n]) or K2-q8 (edge = the edge
// values [nnz]) on carries of type T: one warp an item, the plan's chunks
// then the rows.
template <bool kMxu, typename T>
int launch(const int32_t* indptr, const int32_t* indices, const float* edge,
           const int8_t* q, const float* col_scale, void* y, void* acc,
           int num_rows, int num_features, float scale, int accumulate,
           int carry_bf16, const Split& split, cudaStream_t stream) {
  const bool vec4 = hop_vec4(num_features, q, col_scale, y, acc, carry_bf16);
  auto kernel = kMxu ? (vec4 ? csr_spmm_q8mxu_kernel<4, T>
                             : csr_spmm_q8mxu_kernel<1, T>)
                     : (vec4 ? csr_spmm_q8_kernel<4, T>
                             : csr_spmm_q8_kernel<1, T>);
  const int64_t items = static_cast<int64_t>(split.num_chunks) + num_rows;
  const int64_t blocks = (items + grandtpu::kWarpsPerBlock - 1) /
                         grandtpu::kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), grandtpu::kWarpsPerBlock * 32,
           0, stream>>>(indptr, indices, edge, q, col_scale,
                        static_cast<T*>(y), static_cast<T*>(acc), num_rows,
                        num_features, scale, accumulate, split);
  return static_cast<int>(cudaGetLastError());
}

// The two hops' entry: the plan's arguments as csr_spmm_prop's
// (csr_spmm.cu), partial f32 (K2-q8) or int32 (K2-q8mxu).
template <bool kMxu>
int hop(const int32_t* indptr, const int32_t* indices, const float* edge,
        const int8_t* q, const float* col_scale, void* y, void* acc,
        int num_rows, int num_features, float scale, int accumulate,
        int carry_bf16, const int32_t* split_rows, const int32_t* chunk_ptr,
        const int32_t* chunk_row, const int32_t* chunk_lo, int num_chunks,
        int cap, void* partial, int* counters, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  if (num_chunks > 0 && cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Split split{split_rows, chunk_ptr, chunk_row, chunk_lo, num_chunks,
                    num_chunks ? cap : 0x7fffffff, partial, counters};
  auto fn = carry_bf16 ? launch<kMxu, __nv_bfloat16> : launch<kMxu, float>;
  return fn(indptr, indices, edge, q, col_scale, y, acc, num_rows,
            num_features, scale, accumulate, carry_bf16, split,
            static_cast<cudaStream_t>(stream));
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

// quantize_with_amax: the F column scales from amax_bits (rounded to bf16
// for bf16 x), then q [n, F] int8; writes q and col_scale [F] f32.
extern "C" int quantize_with_amax(const void* x, const unsigned int* amax_bits,
                                  int8_t* q, float* col_scale, int num_rows,
                                  int num_features, int x_bf16, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = grandtpu::carries_vec4(num_features, x, x_bf16) &&
                    grandtpu::aligned(q, 4);
  if (x_bf16) {
    return vec4 ? quantize<__nv_bfloat16, 4>(x, amax_bits, q, col_scale,
                                             num_rows, num_features, 1, s)
                : quantize<__nv_bfloat16, 1>(x, amax_bits, q, col_scale,
                                             num_rows, num_features, 1, s);
  }
  return vec4 ? quantize<float, 4>(x, amax_bits, q, col_scale, num_rows,
                                   num_features, 0, s)
              : quantize<float, 1>(x, amax_bits, q, col_scale, num_rows,
                                   num_features, 0, s);
}

// y, acc [n, F] f32 (carry_bf16 = 0) or bf16, acc may be null when
// accumulate is 0; with bf16 carries scale must already be a bf16 value.
// The split plan (num_chunks = 0: none): the split rows (ascending), each
// one's chunks chunk_ptr[i] : chunk_ptr[i + 1], each chunk's split-row
// index and first edge, the cap; partial is f32 [num_chunks, num_features]
// scratch and counters int32 [split rows], zero before the launch.
extern "C" int csr_spmm_q8(const int32_t* indptr, const int32_t* indices,
                           const float* values, const int8_t* q,
                           const float* col_scale, void* y, void* acc,
                           int num_rows, int num_features, float scale,
                           int accumulate, int carry_bf16,
                           const int32_t* split_rows,
                           const int32_t* chunk_ptr, const int32_t* chunk_row,
                           const int32_t* chunk_lo, int num_chunks, int cap,
                           float* partial, int* counters, void* stream) {
  return hop<false>(indptr, indices, values, q, col_scale, y, acc, num_rows,
                    num_features, scale, accumulate, carry_bf16, split_rows,
                    chunk_ptr, chunk_row, chunk_lo, num_chunks, cap, partial,
                    counters, stream);
}

// As csr_spmm_q8, with row_val [n] f32 in place of the edge values and
// partial int32 [num_chunks, num_features].
extern "C" int csr_spmm_q8mxu(const int32_t* indptr, const int32_t* indices,
                              const float* row_val, const int8_t* q,
                              const float* col_scale, void* y, void* acc,
                              int num_rows, int num_features, float scale,
                              int accumulate, int carry_bf16,
                              const int32_t* split_rows,
                              const int32_t* chunk_ptr,
                              const int32_t* chunk_row,
                              const int32_t* chunk_lo, int num_chunks,
                              int cap, int* partial, int* counters,
                              void* stream) {
  return hop<true>(indptr, indices, row_val, q, col_scale, y, acc, num_rows,
                   num_features, scale, accumulate, carry_bf16, split_rows,
                   chunk_ptr, chunk_row, chunk_lo, num_chunks, cap, partial,
                   counters, stream);
}
