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
//   Three launches: a column-max reduction (per-block partial maxima, then
//   atomicMax on the float bits, which orders non-negative floats), the
//   F column scales, then the elementwise quantize.
// - K2-q8 (spmm_block_q8 / spmm_block_offset_q8 / spmm_split_q8, :460-516):
//   h = (sum_e bf16(q[col_e, f] * bf16(v_e))) * scale[f], f32 sum. The
//   product of two bf16 values is exact in f32, so rounding it once equals
//   JAX's bf16 multiply.
// - K2-q8mxu (spmm_block_q8mxu / spmm_block_offset_q8mxu /
//   spmm_split_q8mxu, :555-616): isum = sum_e q[col_e, f] in int32 (exact,
//   the int8 MXU matmul's job on the TPU), then
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
// for K2. The design is K2's (one warp per row, fused epilogue); where F is
// a multiple of 4 (and the arrays aligned to it) each lane takes 4
// neighbouring features: one 32-bit load of int8 per gathered row, one
// vector load and store of acc and y, so one pass of a warp covers 128
// features. The quantize passes read x 4 elements a load the same way.

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
  float scale = 1.0f;
  if (amax > 0.0f) {
    scale = __fdiv_rn(amax, 127.0f);
    if (scale_bf16) scale = round_bf16(scale);
  }
  col_scale[f] = scale;
}

__device__ __forceinline__ int8_t quantize_one(float v, float scale) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f));
}

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

// kVec int8 features of one gathered row, sign-extended.
__device__ __forceinline__ void load_q(const int8_t* p, int (&v)[1]) {
  v[0] = __ldg(reinterpret_cast<const signed char*>(p));
}

__device__ __forceinline__ void load_q(const int8_t* p, int (&v)[4]) {
  const int w = __ldg(reinterpret_cast<const int*>(p));
  v[0] = static_cast<int8_t>(w & 0xff);
  v[1] = static_cast<int8_t>((w >> 8) & 0xff);
  v[2] = static_cast<int8_t>((w >> 16) & 0xff);
  v[3] = w >> 24;
}

template <int kVec, typename T>
__global__ void csr_spmm_q8_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const float* __restrict__ values,
                                   const int8_t* __restrict__ q,
                                   const float* __restrict__ col_scale,
                                   T* __restrict__ y, T* __restrict__ acc,
                                   int num_rows, int num_features,
                                   float scale, int accumulate) {
  const int64_t row = grandtpu::warp_row(num_rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const int start = indptr[row];
  const int end = indptr[row + 1];
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
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      h[j] = __fmul_rn(s[j], __ldg(col_scale + f0 + j));
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
                                      float scale, int accumulate) {
  const int64_t row = grandtpu::warp_row(num_rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const int start = indptr[row];
  const int end = indptr[row + 1];
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
int quantize(const void* x, unsigned int* amax_bits, int8_t* q,
             float* col_scale, int num_rows, int num_features, int scale_bf16,
             cudaStream_t stream) {
  const int per_block = (num_rows + kMaxRowBlocks - 1) / kMaxRowBlocks;
  const int rows_per_block = per_block > 8 ? per_block : 8;
  const dim3 grid((num_features + 32 * kVec - 1) / (32 * kVec),
                  (num_rows + rows_per_block - 1) / rows_per_block);
  const T* xt = static_cast<const T*>(x);
  column_absmax_kernel<T, kVec><<<grid, dim3(32, 8), 0, stream>>>(
      xt, amax_bits, num_rows, num_features, rows_per_block);
  column_scale_kernel<<<(num_features + 255) / 256, 256, 0, stream>>>(
      amax_bits, col_scale, num_features, scale_bf16);
  const int groups_per_row = num_features / kVec;
  const int64_t groups = static_cast<int64_t>(num_rows) * groups_per_row;
  const int64_t want = (groups + 255) / 256;
  const int64_t blocks = want < 132 * 16 ? want : 132 * 16;
  quantize_kernel<T, kVec><<<static_cast<int>(blocks), 256, 0, stream>>>(
      xt, col_scale, q, groups, groups_per_row);
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
// values [nnz]) on carries of type T.
template <bool kMxu, typename T>
int launch(const int32_t* indptr, const int32_t* indices, const float* edge,
           const int8_t* q, const float* col_scale, void* y, void* acc,
           int num_rows, int num_features, float scale, int accumulate,
           int carry_bf16, cudaStream_t stream) {
  const bool vec4 = hop_vec4(num_features, q, col_scale, y, acc, carry_bf16);
  auto kernel = kMxu ? (vec4 ? csr_spmm_q8mxu_kernel<4, T>
                             : csr_spmm_q8mxu_kernel<1, T>)
                     : (vec4 ? csr_spmm_q8_kernel<4, T>
                             : csr_spmm_q8_kernel<1, T>);
  kernel<<<grandtpu::hop_blocks(num_rows), grandtpu::kWarpsPerBlock * 32, 0,
           stream>>>(indptr, indices, edge, q, col_scale, static_cast<T*>(y),
                     static_cast<T*>(acc), num_rows, num_features, scale,
                     accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of its launches (0 on success).

// x [n, F] f32 (x_bf16 = 0) or bf16; amax_bits [F] zeroed by the caller;
// writes q [n, F] int8 and col_scale [F] f32. n must be > 0.
extern "C" int quantize_columns(const void* x, unsigned int* amax_bits,
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
extern "C" int csr_spmm_q8(const int32_t* indptr, const int32_t* indices,
                           const float* values, const int8_t* q,
                           const float* col_scale, void* y, void* acc,
                           int num_rows, int num_features, float scale,
                           int accumulate, int carry_bf16, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto fn = carry_bf16 ? launch<false, __nv_bfloat16> : launch<false, float>;
  return fn(indptr, indices, values, q, col_scale, y, acc, num_rows,
            num_features, scale, accumulate, carry_bf16,
            static_cast<cudaStream_t>(stream));
}

// As csr_spmm_q8, with row_val [n] f32 in place of the edge values.
extern "C" int csr_spmm_q8mxu(const int32_t* indptr, const int32_t* indices,
                              const float* row_val, const int8_t* q,
                              const float* col_scale, void* y, void* acc,
                              int num_rows, int num_features, float scale,
                              int accumulate, int carry_bf16, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto fn = carry_bf16 ? launch<true, __nv_bfloat16> : launch<true, float>;
  return fn(indptr, indices, row_val, q, col_scale, y, acc, num_rows,
            num_features, scale, accumulate, carry_bf16,
            static_cast<cudaStream_t>(stream));
}
