// Shared pieces of the power-iteration hop kernels (csr_spmm.cu,
// csr_spmm_q8.cu, halo.cu): carry loads, one element or 4 neighbouring ones a lane
// (kVec = 4, where F is a multiple of 4 and the arrays aligned to it: one
// vector load or store instead of four strided ones), and the fused update
//
//   y   = scale * h          h = the hop's f32 product for one element
//   acc = acc + y            only if accumulate
//
// in the carries' dtype. f32 carries round the product and the sum once
// each. bf16 carries follow grandtpu's bf16_carry (infer/propagate.py:
// 111-116, 123-124): h is rounded to bf16 (the hop's .astype), the caller
// passes a scale already rounded to bf16 (JAX rounds a Python scalar to the
// bf16 operand's type), and the product and the sum each round to bf16.
// __fmul_rn/__fadd_rn keep nvcc from contracting a multiply and an add
// into one FMA where JAX rounds between them.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace grandtpu {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_carry(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_carry(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store_hop(float h, float scale, float* y,
                                          float* acc, int64_t i,
                                          int accumulate) {
  const float out = __fmul_rn(scale, h);
  y[i] = out;
  if (accumulate) acc[i] = __fadd_rn(acc[i], out);
}

__device__ __forceinline__ void store_hop(float h, float scale,
                                          __nv_bfloat16* y,
                                          __nv_bfloat16* acc, int64_t i,
                                          int accumulate) {
  const __nv_bfloat16 out = __float2bfloat16_rn(__fmul_rn(scale,
                                                          round_bf16(h)));
  y[i] = out;
  if (accumulate) {
    acc[i] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(acc[i]), __bfloat162float(out)));
  }
}

// The same update for the four neighbouring elements at i (a multiple of
// 4, y and acc aligned to 4 elements).
__device__ __forceinline__ void store_hop4(const float (&h)[4], float scale,
                                           float* y, float* acc, int64_t i,
                                           int accumulate) {
  const float4 out = make_float4(__fmul_rn(scale, h[0]),
                                 __fmul_rn(scale, h[1]),
                                 __fmul_rn(scale, h[2]),
                                 __fmul_rn(scale, h[3]));
  *reinterpret_cast<float4*>(y + i) = out;
  if (accumulate) {
    float4 a = *reinterpret_cast<const float4*>(acc + i);
    a.x = __fadd_rn(a.x, out.x);
    a.y = __fadd_rn(a.y, out.y);
    a.z = __fadd_rn(a.z, out.z);
    a.w = __fadd_rn(a.w, out.w);
    *reinterpret_cast<float4*>(acc + i) = a;
  }
}

__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  return static_cast<unsigned int>(
             __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned int>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(w & 0xffffu)));
}

__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}

__device__ __forceinline__ void store_hop4(const float (&h)[4], float scale,
                                           __nv_bfloat16* y,
                                           __nv_bfloat16* acc, int64_t i,
                                           int accumulate) {
  float out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = round_bf16(__fmul_rn(scale, round_bf16(h[j])));
  }
  *reinterpret_cast<uint2*>(y + i) =
      make_uint2(pack_bf16x2(out[0], out[1]), pack_bf16x2(out[2], out[3]));
  if (accumulate) {
    const uint2 a = *reinterpret_cast<const uint2*>(acc + i);
    *reinterpret_cast<uint2*>(acc + i) = make_uint2(
        pack_bf16x2(__fadd_rn(bf16_lo(a.x), out[0]),
                    __fadd_rn(bf16_hi(a.x), out[1])),
        pack_bf16x2(__fadd_rn(bf16_lo(a.y), out[2]),
                    __fadd_rn(bf16_hi(a.y), out[3])));
  }
}

// kVec neighbouring elements of x as floats (kVec = 4: one 16-byte f32 or
// 8-byte bf16 load, x + i aligned to 4 elements).
__device__ __forceinline__ void load_x(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&v)[1]) {
  v[0] = load_carry(p);
}

__device__ __forceinline__ void load_x(const float* p, float (&v)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}

__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&v)[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lo(w.x);
  v[1] = bf16_hi(w.x);
  v[2] = bf16_lo(w.y);
  v[3] = bf16_hi(w.y);
}

// kVec int8 features of one gathered row, sign-extended (kVec = 4: one
// 32-bit load, p aligned to 4 bytes).
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

// grandtpu's per-column int8 scale, amax / 127 with IEEE division (1 for
// an all-zero column), and q = clamp(rint(v / scale), +-127), rint rounding
// half to even as jnp.round does.
__device__ __forceinline__ float column_scale(float amax) {
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

__device__ __forceinline__ int8_t quantize_one(float v, float scale) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f));
}

// The fused update of kVec neighbouring outputs.
template <typename T>
__device__ __forceinline__ void store_hops(const float (&h)[1], float scale,
                                           T* y, T* acc, int64_t i,
                                           int accumulate) {
  store_hop(h[0], scale, y, acc, i, accumulate);
}

template <typename T>
__device__ __forceinline__ void store_hops(const float (&h)[4], float scale,
                                           T* y, T* acc, int64_t i,
                                           int accumulate) {
  store_hop4(h, scale, y, acc, i, accumulate);
}

inline bool aligned(const void* p, unsigned int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether 4 neighbouring carries of an [n, F] array at p are one aligned
// vector in every row (acc may be null).
inline bool carries_vec4(int num_features, const void* p, int carry_bf16) {
  return num_features % 4 == 0 &&
         (p == nullptr || aligned(p, carry_bf16 ? 8 : 16));
}

// One warp per row: the row of a hop kernel's block, or -1 past the end.
__device__ __forceinline__ int64_t warp_row(int num_rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  return row < num_rows ? row : -1;
}

inline int hop_blocks(int num_rows) {
  return (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace grandtpu
