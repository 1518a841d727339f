// K2 and K2-bf16: CSR SpMM with the power-iteration update fused into its
// epilogue.
//
// Replaces the TPU programs grandtpu/sparse/spmm.py::spmm_split (SplitCSR),
// spmm_block and spmm_block_offset, with fast=False (K2) and fast=True
// (K2-bf16), as driven by grandtpu/infer/propagate.py::_propagate_device.
// One hop computes
//
//   h   = sum_e t(x[col_e] * v_e)   A = D^-1 (adj + I), CSR, f32 values
//   y   = scale * h;  acc += y      (csr_hop.cuh, acc only if accumulate)
//
// where t rounds each term to bf16 in K2-bf16 and is the identity in K2;
// the sum is f32 in both. (ppr: scale = 1 - alpha, accumulate; avg:
// scale = 1, accumulate; single: scale = 1, no accumulate.) The carries x,
// y, acc are f32, or bf16 for grandtpu's bf16_carry; each of the four forms
// has a scalar and a 4-wide instantiation.
//
// What bounds it on an H100: bytes. Per hop the function must read x and
// acc, write y and acc, and read the CSR structure: 4*n*F*c + 8*nnz +
// 4*(n+1) bytes with c = 4 (f32 carries) or 2 (bf16), about 3.28 GB (f32)
// and 1.68 GB (bf16) at the Amazon2M stand-in's [2M, 100], nnz 8.9M; its
// 2*nnz*F flops are far below the f32 rate. The design gives each row one
// warp with lanes striding over F, so every x row a warp gathers is one
// coalesced read per 32 features (per 128 where F is a multiple of 4: each
// lane then loads 4 neighbouring features at once), sums in f32 registers,
// and writes y and acc in the same pass (no second elementwise sweep over
// [n, F]). One warp per row suits graphs without hub rows (the synthetic
// SBM graphs have at most a few dozen nonzeros a row); a hub row is right
// but serialised on one warp, and splitting it across warps, SplitCSR's
// job on the TPU, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_hop.cuh"

namespace {

using grandtpu::round_bf16;

template <bool kTermBf16, int kVec, typename T>
__global__ void csr_spmm_prop_kernel(const int32_t* __restrict__ indptr,
                                     const int32_t* __restrict__ indices,
                                     const float* __restrict__ values,
                                     const T* __restrict__ x,
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
#pragma unroll 4
    for (int e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      const float v = __ldg(values + e);
      float xv[kVec];
      grandtpu::load_x(x + col * num_features + f0, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        // K2-bf16 rounds the f32 product, then to bf16, as JAX does; K2
        // sums with a fused multiply-add (within 1e-5 of JAX's rounded
        // products, and fewer instructions)
        s[j] = kTermBf16 ? __fadd_rn(s[j], round_bf16(__fmul_rn(xv[j], v)))
                         : fmaf(v, xv[j], s[j]);
      }
    }
    grandtpu::store_hops(s, scale, y, acc, out_base + f0, accumulate);
  }
}

template <bool kTermBf16, typename T>
int launch(const int32_t* indptr, const int32_t* indices, const float* values,
           const void* x, void* y, void* acc, int num_rows, int num_features,
           float scale, int accumulate, int carry_bf16, cudaStream_t stream) {
  const bool vec4 = grandtpu::carries_vec4(num_features, x, carry_bf16) &&
                    grandtpu::carries_vec4(num_features, y, carry_bf16) &&
                    grandtpu::carries_vec4(num_features, acc, carry_bf16);
  auto kernel = vec4 ? csr_spmm_prop_kernel<kTermBf16, 4, T>
                     : csr_spmm_prop_kernel<kTermBf16, 1, T>;
  kernel<<<grandtpu::hop_blocks(num_rows), grandtpu::kWarpsPerBlock * 32, 0,
           stream>>>(indptr, indices, values, static_cast<const T*>(x),
                     static_cast<T*>(y), static_cast<T*>(acc), num_rows,
                     num_features, scale, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). acc may be null when
// accumulate is 0. x and y must not alias. term_bf16 selects K2-bf16;
// carry_bf16 says x, y and acc are bf16 (else f32), and then scale must
// already be a bf16 value.
extern "C" int csr_spmm_prop(const int32_t* indptr, const int32_t* indices,
                             const float* values, const void* x, void* y,
                             void* acc, int num_rows, int num_features,
                             float scale, int accumulate, int term_bf16,
                             int carry_bf16, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto fn = carry_bf16 ? (term_bf16 ? launch<true, __nv_bfloat16>
                                    : launch<false, __nv_bfloat16>)
                       : (term_bf16 ? launch<true, float>
                                    : launch<false, float>);
  return fn(indptr, indices, values, x, y, acc, num_rows, num_features, scale,
            accumulate, carry_bf16, s);
}
