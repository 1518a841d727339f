// Shared pieces of the power-iteration hop kernels (csr_spmm.cu,
// csr_spmm_q8.cu, coo_spmm.cu, halo.cu): the hub-row split's work items
// and finish (csr_spmm.cu, csr_spmm_q8.cu; coo_spmm.cu its finish), carry
// loads, one element or 2 or 4 neighbouring ones a lane (kVec = 4 or 2,
// where F is a multiple of it and the arrays aligned to it: one vector
// load or store instead of strided ones), the streamed carries of the
// int8 hops and K2-seg (up to 16 neighbouring ones, with the evict-first
// hint), and the fused update
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

// The same update for two neighbouring elements at i (a multiple of 2, y
// and acc aligned to 2 elements): one 8-byte f32 or 4-byte bf16 access.
__device__ __forceinline__ void store_hop2(const float (&h)[2], float scale,
                                           float* y, float* acc, int64_t i,
                                           int accumulate) {
  const float2 out = make_float2(__fmul_rn(scale, h[0]),
                                 __fmul_rn(scale, h[1]));
  *reinterpret_cast<float2*>(y + i) = out;
  if (accumulate) {
    float2 a = *reinterpret_cast<const float2*>(acc + i);
    a.x = __fadd_rn(a.x, out.x);
    a.y = __fadd_rn(a.y, out.y);
    *reinterpret_cast<float2*>(acc + i) = a;
  }
}

__device__ __forceinline__ void store_hop2(const float (&h)[2], float scale,
                                           __nv_bfloat16* y,
                                           __nv_bfloat16* acc, int64_t i,
                                           int accumulate) {
  const float out0 = round_bf16(__fmul_rn(scale, round_bf16(h[0])));
  const float out1 = round_bf16(__fmul_rn(scale, round_bf16(h[1])));
  *reinterpret_cast<unsigned int*>(y + i) = pack_bf16x2(out0, out1);
  if (accumulate) {
    const unsigned int a = *reinterpret_cast<const unsigned int*>(acc + i);
    *reinterpret_cast<unsigned int*>(acc + i) = pack_bf16x2(
        __fadd_rn(bf16_lo(a), out0), __fadd_rn(bf16_hi(a), out1));
  }
}

// kVec neighbouring elements of x as floats (kVec = 4: one 16-byte f32 or
// 8-byte bf16 load, x + i aligned to 4 elements; kVec = 2: one 8-byte f32
// or 4-byte bf16 load, aligned to 2 elements).
__device__ __forceinline__ void load_x(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&v)[1]) {
  v[0] = load_carry(p);
}

__device__ __forceinline__ void load_x(const float* p, float (&v)[2]) {
  const float2 w = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = w.x;
  v[1] = w.y;
}

__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&v)[2]) {
  const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));
  v[0] = bf16_lo(w);
  v[1] = bf16_hi(w);
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
__device__ __forceinline__ void store_hops(const float (&h)[2], float scale,
                                           T* y, T* acc, int64_t i,
                                           int accumulate) {
  store_hop2(h, scale, y, acc, i, accumulate);
}

template <typename T>
__device__ __forceinline__ void store_hops(const float (&h)[4], float scale,
                                           T* y, T* acc, int64_t i,
                                           int accumulate) {
  store_hop4(h, scale, y, acc, i, accumulate);
}

// Streamed carries (csr_spmm_q8.cu's and coo_spmm.cu's hops): kN
// neighbouring carries read as floats, and the fused update written back,
// with the evict-first hint (__ldcs / __stcs: ld.global.cs /
// st.global.cs). Each carry is read or
// written once a hop, so the hint leaves the L2 to the rows the hop
// gathers. kN is 1, 2, 4, 8 or 16, and p is aligned to kN elements or to
// 16 bytes, whichever is less. acc is read before the hop's gathers and
// its values passed to store_update, so that the two loads' latencies
// overlap.
template <int kN>
__device__ __forceinline__ void load_carries(const float* p, float (&a)[kN]) {
  if constexpr (kN >= 4) {
#pragma unroll
    for (int k = 0; k < kN / 4; ++k) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p) + k);
      a[4 * k] = t.x;
      a[4 * k + 1] = t.y;
      a[4 * k + 2] = t.z;
      a[4 * k + 3] = t.w;
    }
  } else if constexpr (kN == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    a[0] = t.x;
    a[1] = t.y;
  } else {
    a[0] = __ldcs(p);
  }
}

template <int kN>
__device__ __forceinline__ void load_carries(const __nv_bfloat16* p,
                                             float (&a)[kN]) {
  if constexpr (kN >= 8) {
#pragma unroll
    for (int k = 0; k < kN / 8; ++k) {
      const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p) + k);
      const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[8 * k + 2 * j] = bf16_lo(w[j]);
        a[8 * k + 2 * j + 1] = bf16_hi(w[j]);
      }
    }
  } else if constexpr (kN == 4) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    a[0] = bf16_lo(t.x);
    a[1] = bf16_hi(t.x);
    a[2] = bf16_lo(t.y);
    a[3] = bf16_hi(t.y);
  } else if constexpr (kN == 2) {
    const unsigned int t = __ldcs(reinterpret_cast<const unsigned int*>(p));
    a[0] = bf16_lo(t);
    a[1] = bf16_hi(t);
  } else {
    a[0] = __bfloat162float(__ushort_as_bfloat16(
        __ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
}

template <int kN>
__device__ __forceinline__ void store_carries(float* p,
                                              const float (&v)[kN]) {
  if constexpr (kN >= 4) {
#pragma unroll
    for (int k = 0; k < kN / 4; ++k) {
      __stcs(reinterpret_cast<float4*>(p) + k,
             make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
    }
  } else if constexpr (kN == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// bf16 carries: each value rounded to bf16 as it is packed.
template <int kN>
__device__ __forceinline__ void store_carries(__nv_bfloat16* p,
                                              const float (&v)[kN]) {
  if constexpr (kN >= 8) {
#pragma unroll
    for (int k = 0; k < kN / 8; ++k) {
      const float* w = v + 8 * k;
      __stcs(reinterpret_cast<uint4*>(p) + k,
             make_uint4(pack_bf16x2(w[0], w[1]), pack_bf16x2(w[2], w[3]),
                        pack_bf16x2(w[4], w[5]), pack_bf16x2(w[6], w[7])));
    }
  } else if constexpr (kN == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3])));
  } else if constexpr (kN == 2) {
    __stcs(reinterpret_cast<unsigned int*>(p), pack_bf16x2(v[0], v[1]));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
}

// The fused update of kN neighbouring outputs at i, with a = acc's values
// there (load_carries): f32 carries y = scale * h, acc = a + y; bf16
// carries as store_hop's. out gets the values of y as stored (bf16-rounded
// for bf16 carries), for a caller that takes their column maxima.
template <int kN>
__device__ __forceinline__ void store_update(const float (&h)[kN],
                                             const float (&a)[kN],
                                             float scale, float* y,
                                             float* acc, int64_t i,
                                             int accumulate,
                                             float (&out)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) out[j] = __fmul_rn(scale, h[j]);
  store_carries(y + i, out);
  if (accumulate) {
    float sum[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) sum[j] = __fadd_rn(a[j], out[j]);
    store_carries(acc + i, sum);
  }
}

template <int kN>
__device__ __forceinline__ void store_update(const float (&h)[kN],
                                             const float (&a)[kN],
                                             float scale, __nv_bfloat16* y,
                                             __nv_bfloat16* acc, int64_t i,
                                             int accumulate,
                                             float (&out)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    out[j] = round_bf16(__fmul_rn(scale, round_bf16(h[j])));
  }
  store_carries(y + i, out);
  if (accumulate) {
    float sum[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) sum[j] = __fadd_rn(a[j], out[j]);
    store_carries(acc + i, sum);
  }
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

// The hub-row split plan of a hop (sparse/spmm.py::SplitPlan; num_chunks
// 0: none) and its scratch: partial [num_chunks, F] (f32, or int32 for
// K2-q8mxu) and counters [split rows], zero before the launch.
struct Split {
  const int32_t* rows;        // the split rows, ascending
  const int32_t* chunk_ptr;   // split row i has chunks chunk_ptr[i]:[i + 1]
  const int32_t* chunk_row;   // each chunk's split-row index
  const int32_t* chunk_lo;    // each chunk's first edge
  int num_chunks;
  int cap;                    // edges a chunk, and the longest whole row
  void* partial;
  int* counters;
};

// A group's work item: the plan's chunks first (the heavy work starts
// first), then the rows. Sets the row and its edge range lo:hi; false past
// the end and for a split row's own item, whose chunks add it.
__device__ __forceinline__ bool hop_item(const int32_t* __restrict__ indptr,
                                         int num_rows, const Split& s,
                                         int64_t item, int64_t& row, int& lo,
                                         int& hi) {
  if (item >= static_cast<int64_t>(s.num_chunks) + num_rows) return false;
  if (item < s.num_chunks) {
    row = s.rows[s.chunk_row[item]];
    lo = s.chunk_lo[item];
    const int end = indptr[row + 1];
    hi = end - lo > s.cap ? lo + s.cap : end;
    return true;
  }
  row = item - s.num_chunks;
  lo = indptr[row];
  hi = indptr[row + 1];
  return hi - lo <= s.cap;
}

// After a chunk's group of `lanes` lanes (a power of two up to 32, aligned
// in its warp) wrote its partial: whether it finished its split row's last
// chunk (an integer counter a split row, no float atomics). The whole group
// calls it; the fences make every chunk's partial visible to the group
// that adds them.
__device__ __forceinline__ bool last_chunk(const Split& s, int64_t item,
                                           int lanes = 32) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = lanes == 32
      ? 0xffffffffu : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  __threadfence();
  __syncwarp(mask);
  const int i = s.chunk_row[item];
  int last = 0;
  if ((lane & (lanes - 1)) == 0) {
    last = atomicAdd(s.counters + i, 1) ==
           s.chunk_ptr[i + 1] - s.chunk_ptr[i] - 1;
  }
  last = __shfl_sync(mask, last, 0, lanes);
  if (last) __threadfence();
  return last;
}

}  // namespace grandtpu
