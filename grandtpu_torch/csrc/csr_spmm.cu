// K2: CSR SpMM with the power-iteration update fused into its epilogue.
//
// Replaces the TPU programs grandtpu/sparse/spmm.py::spmm_split (SplitCSR),
// spmm_block and spmm_block_offset, as driven by
// grandtpu/infer/propagate.py::_propagate_device. One hop computes
//
//   y   = scale * (A @ x)          A = D^-1 (adj + I), CSR, f32 values
//   acc = acc + y                  only if accumulate
//
// (ppr: scale = 1 - alpha, accumulate; avg: scale = 1, accumulate;
//  single: scale = 1, no accumulate).
//
// What bounds it on an H100: bytes. Per hop the function must read x and
// acc, write y and acc, and read the CSR structure: 4*n*F*4 + 8*nnz +
// 4*(n+1) bytes, about 2.25 GB for the 233K-node, F=602 reddit stand-in
// (0.67 ms at 3.35 TB/s); its 2*nnz*F flops are far below the f32 rate. The
// design gives each row one warp with lanes striding over F, so every x row
// a warp gathers is one coalesced 128-byte read per 32 features, sums in
// f32 registers, and writes y and acc in the same pass (no second
// elementwise sweep over [n, F]). One warp per row suits graphs without hub
// rows (the synthetic SBM graphs have at most a few dozen nonzeros a row);
// splitting hub rows across warps, SplitCSR's job on the TPU, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void csr_spmm_prop_kernel(const int32_t* __restrict__ indptr,
                                     const int32_t* __restrict__ indices,
                                     const float* __restrict__ values,
                                     const float* __restrict__ x,
                                     float* __restrict__ y,
                                     float* __restrict__ acc, int num_rows,
                                     int num_features, float scale,
                                     int accumulate) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= num_rows) return;
  const int lane = threadIdx.x & 31;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const int64_t out_base = row * num_features;
  for (int f = lane; f < num_features; f += 32) {
    float s = 0.0f;
#pragma unroll 4
    for (int e = start; e < end; ++e) {
      const int64_t col = __ldg(indices + e);
      s = fmaf(__ldg(values + e), __ldg(x + col * num_features + f), s);
    }
    const float out = scale * s;
    y[out_base + f] = out;
    if (accumulate) acc[out_base + f] += out;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). acc may be null when
// accumulate is 0. x and y must not alias.
extern "C" int csr_spmm_prop_f32(const int32_t* indptr, const int32_t* indices,
                                 const float* values, const float* x,
                                 float* y, float* acc, int num_rows,
                                 int num_features, float scale,
                                 int accumulate, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  const int blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_spmm_prop_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      indptr, indices, values, x, y, acc, num_rows, num_features, scale,
      accumulate);
  return static_cast<int>(cudaGetLastError());
}
