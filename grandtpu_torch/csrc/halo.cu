// D1, the halo exchange of row-partitioned propagation: halo_pack and
// halo_hop.
//
// Replace the per-shard programs of grandtpu/dist/halo.py::HaloPropagator
// (halo.py:305-328): each shard gathers the rows its peers need (send,
// quantized to int8 for the int8 forms), the mesh exchanges them
// (all_to_all, outside the kernels), and each shard computes
//
//   h   = h_d + h_h
//   h_d = sum over the diagonal edges of x_local[c] * v      always f32
//   h_h = sum over the halo edges of recv[c] * v, as
//         f32:        f32 terms, f32 sum;
//         int8 cast:  bf16(q * bf16(v)) terms, f32 sum, times scale[f];
//         int8 exact: (float(int32 sum of q) * row_val[r]) * scale[f]
//   y   = hop_scale * h;  acc += y     (csr_hop.cuh)
//
// with the two partial sums kept apart and added as grandtpu adds them.
// grandtpu's halo variant rounds nothing to bf16 at precision 'bf16' (its
// onehot_spmm casts int8 sources only), so that form is the f32 one here
// too, kept so on purpose.
//
// What bounds them on an H100: bytes. halo_pack must read the S * C_max
// gathered rows and the index and write the send buffer (4 or 1 bytes an
// element); halo_hop must read both CSR structures, x_local and the
// receive buffer once, and read and write the carries. The design is K2's
// (csr_spmm.cu): one warp a row (a send row, a local row), lanes over
// features, 4 neighbouring features a lane where F is a multiple of 4 and
// the arrays aligned to it. halo_pack quantizes in the same pass as the
// gather (clamp(rint(x / scale)) with IEEE division: the int8 rows are bit
// for bit grandtpu's jnp.take of its quantized block), from the global
// column maxima the caller reduced over the shards. halo_hop adds each
// partial sum in edge order with rounded products (no fused multiply-add),
// as its plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_hop.cuh"

namespace {

using grandtpu::round_bf16;

__device__ __forceinline__ void store_row(float* p, const float (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_row(int8_t* p, const int8_t (&v)[1]) {
  *p = v[0];
}

__device__ __forceinline__ void store_row(int8_t* p, const int8_t (&v)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
}

// out[i, :] = x[idx[i], :], as f32 or quantized with the scales of amax;
// with kQuant the warp of row 0 also writes the F column scales.
template <int kVec, bool kQuant>
__global__ void halo_pack_kernel(const float* __restrict__ x,
                                 const int32_t* __restrict__ idx,
                                 const float* __restrict__ amax,
                                 float* __restrict__ col_scale,
                                 void* __restrict__ out, int num_out,
                                 int num_features) {
  const int64_t row = grandtpu::warp_row(num_out);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t src = __ldg(idx + row);
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    float v[kVec];
    grandtpu::load_x(x + src * num_features + f0, v);
    const int64_t o = row * num_features + f0;
    if (kQuant) {
      int8_t q[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float scale = grandtpu::column_scale(__ldg(amax + f0 + j));
        q[j] = grandtpu::quantize_one(v[j], scale);
        if (row == 0) col_scale[f0 + j] = scale;
      }
      store_row(static_cast<int8_t*>(out) + o, q);
    } else {
      store_row(static_cast<float*>(out) + o, v);
    }
  }
}

enum HaloForm { kHaloF32 = 0, kHaloCast = 1, kHaloExact = 2 };

template <int kForm, int kVec>
__global__ void halo_hop_kernel(
    const int32_t* __restrict__ d_ptr, const int32_t* __restrict__ d_idx,
    const float* __restrict__ d_val, const float* __restrict__ x,
    const int32_t* __restrict__ h_ptr, const int32_t* __restrict__ h_idx,
    const float* __restrict__ h_val, const void* __restrict__ recv,
    const float* __restrict__ col_scale, const float* __restrict__ row_val,
    float* __restrict__ y, float* __restrict__ acc, int num_rows,
    int num_features, float scale, int accumulate) {
  const int64_t row = grandtpu::warp_row(num_rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const int d0 = d_ptr[row], d1 = d_ptr[row + 1];
  const int h0 = h_ptr[row], h1 = h_ptr[row + 1];
  const int64_t out_base = row * num_features;
  for (int f0 = lane * kVec; f0 < num_features; f0 += 32 * kVec) {
    float hd[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) hd[j] = 0.0f;
    for (int e = d0; e < d1; ++e) {
      const int64_t col = __ldg(d_idx + e);
      const float v = __ldg(d_val + e);
      float xv[kVec];
      grandtpu::load_x(x + col * num_features + f0, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) hd[j] = __fadd_rn(hd[j], __fmul_rn(xv[j], v));
    }
    float hh[kVec];
    if (kForm == kHaloExact) {
      int isum[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) isum[j] = 0;
      for (int e = h0; e < h1; ++e) {
        const int64_t col = __ldg(h_idx + e);
        int qv[kVec];
        grandtpu::load_q(static_cast<const int8_t*>(recv) +
                             col * num_features + f0, qv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) isum[j] += qv[j];
      }
      const float rv = __ldg(row_val + row);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        hh[j] = __fmul_rn(__fmul_rn(__int2float_rn(isum[j]), rv),
                          __ldg(col_scale + f0 + j));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) hh[j] = 0.0f;
      for (int e = h0; e < h1; ++e) {
        const int64_t col = __ldg(h_idx + e);
        if (kForm == kHaloCast) {
          const float v = round_bf16(__ldg(h_val + e));
          int qv[kVec];
          grandtpu::load_q(static_cast<const int8_t*>(recv) +
                               col * num_features + f0, qv);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            hh[j] = __fadd_rn(hh[j], round_bf16(__fmul_rn(
                                         static_cast<float>(qv[j]), v)));
          }
        } else {
          const float v = __ldg(h_val + e);
          float rv[kVec];
          grandtpu::load_x(static_cast<const float*>(recv) +
                               col * num_features + f0, rv);
#pragma unroll
          for (int j = 0; j < kVec; ++j) hh[j] = __fadd_rn(hh[j], __fmul_rn(rv[j], v));
        }
      }
      if (kForm == kHaloCast) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          hh[j] = __fmul_rn(hh[j], __ldg(col_scale + f0 + j));
        }
      }
    }
    float h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = __fadd_rn(hd[j], hh[j]);
    grandtpu::store_hops(h, scale, y, acc, out_base + f0, accumulate);
  }
}

template <int kForm>
int launch_hop(const int32_t* d_ptr, const int32_t* d_idx, const float* d_val,
               const float* x, const int32_t* h_ptr, const int32_t* h_idx,
               const float* h_val, const void* recv, const float* col_scale,
               const float* row_val, float* y, float* acc, int num_rows,
               int num_features, float scale, int accumulate,
               cudaStream_t stream) {
  const bool vec4 = grandtpu::carries_vec4(num_features, x, 0) &&
                    grandtpu::carries_vec4(num_features, y, 0) &&
                    grandtpu::carries_vec4(num_features, acc, 0) &&
                    grandtpu::aligned(recv, kForm == kHaloF32 ? 16 : 4) &&
                    (col_scale == nullptr || grandtpu::aligned(col_scale, 16));
  auto kernel = vec4 ? halo_hop_kernel<kForm, 4> : halo_hop_kernel<kForm, 1>;
  kernel<<<grandtpu::hop_blocks(num_rows), grandtpu::kWarpsPerBlock * 32, 0,
           stream>>>(d_ptr, d_idx, d_val, x, h_ptr, h_idx, h_val, recv,
                     col_scale, row_val, y, acc, num_rows, num_features,
                     scale, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).

// x [rows, F] f32, idx [num_out] int32 row ids; out [num_out, F] f32, or
// int8 when quantize is 1: then amax [F] f32 (the global column maxima) is
// read and col_scale [F] f32 written.
extern "C" int halo_pack(const float* x, const int32_t* idx, const float* amax,
                         float* col_scale, void* out, int num_out,
                         int num_features, int quantize, void* stream) {
  if (num_out == 0 || num_features == 0) return 0;
  const bool vec4 = grandtpu::carries_vec4(num_features, x, 0) &&
                    grandtpu::aligned(out, quantize ? 4 : 16) &&
                    (!quantize || grandtpu::aligned(amax, 16));
  auto kernel = quantize ? (vec4 ? halo_pack_kernel<4, true>
                                 : halo_pack_kernel<1, true>)
                         : (vec4 ? halo_pack_kernel<4, false>
                                 : halo_pack_kernel<1, false>);
  kernel<<<grandtpu::hop_blocks(num_out), grandtpu::kWarpsPerBlock * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(x, idx, amax, col_scale, out,
                                                num_out, num_features);
  return static_cast<int>(cudaGetLastError());
}

// The diagonal CSR (d_*, columns into x_local [rows, F] f32) and the halo
// CSR (h_*, columns into recv [S * C_max, F]), both with num_rows rows.
// form 0: recv f32 (h_val read); 1: recv int8, bf16 terms (h_val and
// col_scale read); 2: recv int8, exact int32 sums (row_val [num_rows] and
// col_scale read, h_val not). y, acc [num_rows, F] f32 (acc may be null
// when accumulate is 0) must not alias x.
extern "C" int halo_hop(const int32_t* d_ptr, const int32_t* d_idx,
                        const float* d_val, const float* x,
                        const int32_t* h_ptr, const int32_t* h_idx,
                        const float* h_val, const void* recv,
                        const float* col_scale, const float* row_val,
                        float* y, float* acc, int num_rows, int num_features,
                        float scale, int accumulate, int form, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto fn = form == kHaloExact  ? launch_hop<kHaloExact>
            : form == kHaloCast ? launch_hop<kHaloCast>
                                : launch_hop<kHaloF32>;
  return fn(d_ptr, d_idx, d_val, x, h_ptr, h_idx, h_val, recv, col_scale,
            row_val, y, acc, num_rows, num_features, scale, accumulate, s);
}
