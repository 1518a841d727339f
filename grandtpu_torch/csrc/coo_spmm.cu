// K2-seg: y = A @ x for A as padded, row-sorted COO (rows, cols, vals),
// the low-memory 'segment' backend of the power iteration.
//
// Replaces the TPU program grandtpu/sparse/spmm.py::spmm_segment (a
// lax.scan over edge chunks: gather x[cols] * vals, scatter-add into an
// [n + 1, F] accumulator whose last row swallows the padding), as driven by
// grandtpu/infer/propagate.py::_propagate_device with backend='segment' and
// per shard by grandtpu/dist/spmm_shard.py::_sharded_prop. It reads only
// rows, cols and vals (no indptr: low memory is the backend's reason to
// exist) and adds into a zeroed [num_rows + 1, F] f32 output. The
// power-iteration update stays outside, as in grandtpu.
//
// What bounds it on an H100: bytes. It must read the 12 bytes of each
// (padded) edge, x once and write y once: at the Amazon2M stand-in
// (nnz 8.9M, [2M, 100]) about 1.71 GB; its 2*nnz*F flops are far below the
// f32 rate. The design: each warp walks a fixed run of kRun = 32
// consecutive edges (one edge a lane, loaded once and passed around with
// warp shuffles), lanes over features (4 neighbouring features a lane
// where F is a multiple of 4 and the arrays aligned to it), keeps the
// current row's sum in registers in edge order and flushes it at each row
// change. A row wholly inside the run is stored; the first and the last
// row of a run, when the row goes on in the neighbouring run, are added
// with atomicAdd. So a hub row spanning many runs takes one atomic a run,
// and its sum order varies from run to run (held to the plain version at
// <= 1e-5 relative, not bit for bit); every other row adds in edge order.
// Padding edges (row = num_rows) come last in sorted order and are
// skipped. Offsets into x and y are 64-bit: E * F passes 2^31 near the
// Amazon2M stand-in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_hop.cuh"

namespace {

constexpr int kRun = 32;   // edges a warp walks: one a lane

__device__ __forceinline__ void flush(float* y, const float (&s)[1], int64_t i,
                                      bool shared) {
  if (shared) {
    atomicAdd(y + i, s[0]);
  } else {
    y[i] = s[0];
  }
}

__device__ __forceinline__ void flush(float* y, const float (&s)[4], int64_t i,
                                      bool shared) {
  if (shared) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(y + i + j, s[j]);
  } else {
    *reinterpret_cast<float4*>(y + i) = make_float4(s[0], s[1], s[2], s[3]);
  }
}

template <int kVec>
__global__ void coo_spmm_kernel(const int32_t* __restrict__ rows,
                                const int32_t* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t num_edges,
                                int num_rows, int num_features) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * grandtpu::kWarpsPerBlock +
      threadIdx.x / 32;
  const int64_t e0 = warp * kRun;
  if (e0 >= num_edges) return;
  const int lane = threadIdx.x & 31;
  const int count = num_edges - e0 < kRun ? static_cast<int>(num_edges - e0)
                                          : kRun;
  // this lane's edge; past the end it reads as padding
  int my_row = num_rows, my_col = 0;
  float my_val = 0.0f;
  if (lane < count) {
    my_row = __ldg(rows + e0 + lane);
    my_col = __ldg(cols + e0 + lane);
    my_val = __ldg(vals + e0 + lane);
  }
  const int first_row = __shfl_sync(0xffffffffu, my_row, 0);
  if (first_row >= num_rows) return;   // padding only
  const int last_row = __shfl_sync(0xffffffffu, my_row, count - 1);
  // whether the run's first row began in the previous run, and whether its
  // last row goes on into the next one: those two are added atomically
  const bool from_prev = e0 > 0 && __ldg(rows + e0 - 1) == first_row;
  const bool into_next =
      e0 + count < num_edges && __ldg(rows + e0 + count) == last_row;
  // every lane takes part in every shuffle: the chunk loop is the warp's,
  // and lanes past the last feature only skip the loads and stores
  for (int base = 0; base < num_features; base += 32 * kVec) {
    const int f0 = base + lane * kVec;
    const bool active = f0 < num_features;
    float s[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = 0.0f;
    int row = first_row;
    for (int k = 0; k < count; ++k) {
      const int r = __shfl_sync(0xffffffffu, my_row, k);
      const int c = __shfl_sync(0xffffffffu, my_col, k);
      const float v = __shfl_sync(0xffffffffu, my_val, k);
      if (r != row) {
        if (active) {
          flush(y, s, static_cast<int64_t>(row) * num_features + f0,
                row == first_row && from_prev);
        }
        row = r;
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[j] = 0.0f;
      }
      if (r >= num_rows) break;      // the padding from here on
      if (active) {
        float xv[kVec];
        grandtpu::load_x(x + static_cast<int64_t>(c) * num_features + f0,
                         xv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[j] = __fadd_rn(s[j], __fmul_rn(xv[j], v));
        }
      }
    }
    if (active && row < num_rows) {
      flush(y, s, static_cast<int64_t>(row) * num_features + f0,
            (row == first_row && from_prev) || (row == last_row && into_next));
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). rows, cols, vals
// [num_edges] (rows sorted, padding rows = num_rows at the end, which the
// caller checks), x [num_cols, F] f32, y [num_rows + 1, F] f32 zeroed by
// the caller (its last row stays zero: the padding is skipped).
extern "C" int coo_spmm(const int32_t* rows, const int32_t* cols,
                        const float* vals, const float* x, float* y,
                        int64_t num_edges, int num_rows, int num_features,
                        void* stream) {
  if (num_edges == 0 || num_rows == 0 || num_features == 0) return 0;
  const int64_t warps = (num_edges + kRun - 1) / kRun;
  const int64_t blocks =
      (warps + grandtpu::kWarpsPerBlock - 1) / grandtpu::kWarpsPerBlock;
  const bool vec4 = grandtpu::carries_vec4(num_features, x, 0) &&
                    grandtpu::carries_vec4(num_features, y, 0);
  auto kernel = vec4 ? coo_spmm_kernel<4> : coo_spmm_kernel<1>;
  kernel<<<static_cast<unsigned int>(blocks), grandtpu::kWarpsPerBlock * 32,
           0, static_cast<cudaStream_t>(stream)>>>(
      rows, cols, vals, x, y, num_edges, num_rows, num_features);
  return static_cast<int>(cudaGetLastError());
}
