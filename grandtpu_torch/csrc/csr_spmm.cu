// K2 and K2-bf16: CSR SpMM with the power-iteration update fused into its
// epilogue, with hub rows split by nonzero count.
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
// y, acc are f32, or bf16 for grandtpu's bf16_carry.
//
// What bounds it on an H100: bytes. Per hop the function must read x and
// acc, write y and acc, and read the CSR structure: 4*n*F*c + 8*nnz +
// 4*(n+1) bytes with c = 4 (f32 carries) or 2 (bf16); its 2*nnz*F flops
// are far below the f32 rate. A gather reads nnz rows of x, not n, so
// unless the L2 catches the reuse the floor is nnz*F*c bytes of gathers
// plus the carries (3.55 GB of gathers at the Amazon2M stand-in).
//
// The design:
// - A group of G lanes (a power of two up to 32) takes one row, so a warp
//   holds 32/G rows where F is narrow (MAG's H = 64: 16 lanes, two rows a
//   warp, no idle half warp). Each lane owns NPER vectors of V neighbouring
//   features, lanes side by side, so each gathered x row is read with
//   8- or 16-byte loads (V = 2 where F is even and the rows 8-byte
//   aligned, as at reddit's 602; V = 1 on misaligned views). Where F needs
//   more than G*NPER*V features the row's edges are walked once per tile.
// - U edges at a time: their (col, val) pairs are loaded first, all U at
//   once (one broadcast load a lane, from L1 after the first), then their
//   U*NPER x-row loads are issued together before any term is added, so a
//   lane keeps several gathers in flight instead of a chain of dependent
//   loads. MINB blocks an SM caps the registers so that enough warps stay
//   resident: more warps in flight beat fewer load instructions (loading
//   a row's pairs once and shuffling them, with more registers, ran
//   slower). The configuration is pick_config's.
// - Each row's terms are added in edge order into f32 registers, and y and
//   acc are written in the same pass (no second sweep over [n, F]).
// - Hub rows: a row with more than `cap` nonzeros is cut by the host's
//   split plan (sparse/spmm.py::SplitPlan) into chunks of at most cap
//   edges. The grid's first items are the chunks (so the heavy work starts
//   first), then the rows; a split row's own item does nothing. A chunk
//   writes its f32 partial sum to the caller's [chunks, F] scratch, and
//   the group that finishes a split row's last chunk (an integer counter
//   a split row, no float atomics) adds that row's partials in chunk order
//   and applies the fused update. So the sums are the same on every run,
//   rows under the cap keep the unsplit order, and the hop is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_hop.cuh"

namespace {

using grandtpu::round_bf16;

constexpr int kThreads = 256;

template <bool kTermBf16>
__device__ __forceinline__ float add_term(float s, float x, float v) {
  // K2-bf16 rounds the f32 product, then to bf16, as JAX does; K2 sums
  // with a fused multiply-add (within 1e-5 of JAX's rounded products)
  return kTermBf16 ? __fadd_rn(s, round_bf16(__fmul_rn(x, v)))
                   : fmaf(v, x, s);
}

template <bool kTermBf16, int V, int NPER, int U, int MINB, typename T>
__global__ void __launch_bounds__(kThreads, MINB)
csr_spmm_prop_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ values,
                     const T* __restrict__ x, T* __restrict__ y,
                     T* __restrict__ acc, int num_rows, int num_features,
                     float scale, int accumulate, int lanes, int log_lanes,
                     grandtpu::Split split) {
  const int g = threadIdx.x & (lanes - 1);
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
      log_lanes;
  int64_t row;
  int lo, hi;
  if (!grandtpu::hop_item(indptr, num_rows, split, item, row, lo, hi)) {
    return;
  }
  const bool is_chunk = item < split.num_chunks;
  float* partial = static_cast<float*>(split.partial);
  const int F = num_features;
  const int tile = lanes * NPER * V;
  for (int f_tile = 0; f_tile < F; f_tile += tile) {
    float s[NPER][V];
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
#pragma unroll
      for (int q = 0; q < V; ++q) s[p][q] = 0.0f;
    }
    int e = lo;
    // U edges at a time: their (col, val) loads, then their x rows' loads,
    // then their terms in edge order
    for (; e + U <= hi; e += U) {
      int c[U];
      float v[U];
      float xv[U][NPER][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = __ldg(indices + e + u);
        v[u] = __ldg(values + e + u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
          const int f = f_tile + (p * lanes + g) * V;
          if (f < F) {
            grandtpu::load_x(x + static_cast<int64_t>(c[u]) * F + f,
                             xv[u][p]);
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) xv[u][p][q] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
#pragma unroll
          for (int q = 0; q < V; ++q) {
            s[p][q] = add_term<kTermBf16>(s[p][q], xv[u][p][q], v[u]);
          }
        }
      }
    }
    for (; e < hi; ++e) {
      const int c = __ldg(indices + e);
      const float v = __ldg(values + e);
#pragma unroll
      for (int p = 0; p < NPER; ++p) {
        const int f = f_tile + (p * lanes + g) * V;
        if (f < F) {
          float xv[V];
          grandtpu::load_x(x + static_cast<int64_t>(c) * F + f, xv);
#pragma unroll
          for (int q = 0; q < V; ++q) {
            s[p][q] = add_term<kTermBf16>(s[p][q], xv[q], v);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
      const int f = f_tile + (p * lanes + g) * V;
      if (f >= F) continue;
      if (is_chunk) {
#pragma unroll
        for (int q = 0; q < V; ++q) partial[item * F + f + q] = s[p][q];
      } else {
        grandtpu::store_hops(s[p], scale, y, acc, row * F + f, accumulate);
      }
    }
  }
  if (!is_chunk || !grandtpu::last_chunk(split, item, lanes)) return;
  // the last chunk of a split row to finish adds the row's partials in
  // chunk order and applies the update
  const int i = split.chunk_row[item];
  const int c0 = split.chunk_ptr[i];
  const int c1 = split.chunk_ptr[i + 1];
  for (int f = g; f < F; f += lanes) {
    float h = 0.0f;
    for (int c = c0; c < c1; ++c) {
      h = __fadd_rn(h, __ldcg(partial + static_cast<int64_t>(c) * F + f));
    }
    grandtpu::store_hop(h, scale, y, acc, row * F + f, accumulate);
  }
}

// The widest vector (4, 2 or 1 elements) that F and the alignment of x, y
// and acc allow.
int vec_width(int num_features, int carry_bytes, const void* x,
              const void* y, const void* acc) {
  for (int v = 4; v > 1; v /= 2) {
    const unsigned int bytes = v * carry_bytes;
    if (num_features % v == 0 && grandtpu::aligned(x, bytes) &&
        grandtpu::aligned(y, bytes) &&
        (acc == nullptr || grandtpu::aligned(acc, bytes))) {
      return v;
    }
  }
  return 1;
}

// A launch configuration: V features a vector, NPER vectors a lane, U
// edges gathered before their terms are added, MINB blocks an SM (the
// register budget: 8 blocks of 256 threads leave 32 registers a thread).
struct Config {
  int v, nper, u, minb;
};

// The configuration for carries that allow vectors of up to vmax elements,
// chosen by timing configurations on an H100 on the port's operators
// (reddit F 602, MAG H 64, Amazon2M F 100, P1's A^T at 512; f32 and bf16
// carries): the widest vector, two edges in flight and 8 blocks an SM
// (32 registers a thread) came out fastest or close to it at each width.
Config pick_config(int vmax) {
  if (vmax >= 4) return {4, 1, 2, 8};
  if (vmax == 2) return {2, 2, 2, 8};
  return {1, 2, 4, 8};
}

#define K2_CONFIGS(X) X(4, 1, 2, 8) X(2, 2, 2, 8) X(1, 2, 4, 8)

template <bool kTermBf16, typename T>
using Kernel = decltype(&csr_spmm_prop_kernel<kTermBf16, 1, 1, 1, 1, T>);

template <bool kTermBf16, typename T>
Kernel<kTermBf16, T> kernel_for(const Config& c) {
#define K2_PICK(V, N, U, M)                                          \
  if (c.v == V && c.nper == N && c.u == U && c.minb == M) {          \
    return csr_spmm_prop_kernel<kTermBf16, V, N, U, M, T>;           \
  }
  K2_CONFIGS(K2_PICK)
#undef K2_PICK
  return nullptr;
}

template <bool kTermBf16, typename T>
int launch(const int32_t* indptr, const int32_t* indices, const float* values,
           const void* x, void* y, void* acc, int num_rows, int num_features,
           float scale, int accumulate, const int32_t* split_rows,
           const int32_t* chunk_ptr, const int32_t* chunk_row,
           const int32_t* chunk_lo, int num_chunks, int cap, float* partial,
           int* counters, cudaStream_t stream) {
  const int vmax = vec_width(num_features, sizeof(T), x, y, acc);
  const Config cfg = pick_config(vmax);
  const int vecs = (num_features + cfg.v - 1) / cfg.v;
  int lanes = 1;
  while (lanes < 32 && lanes * cfg.nper < vecs) lanes *= 2;
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes) ++log_lanes;
  const int64_t threads =
      (static_cast<int64_t>(num_chunks) + num_rows) * lanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_for<kTermBf16, T>(cfg);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      indptr, indices, values, static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<T*>(acc), num_rows, num_features, scale, accumulate, lanes,
      log_lanes,
      grandtpu::Split{split_rows, chunk_ptr, chunk_row, chunk_lo, num_chunks,
                      num_chunks ? cap : 0x7fffffff, partial, counters});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). acc may be null when
// accumulate is 0. x and y must not alias. term_bf16 selects K2-bf16;
// carry_bf16 says x, y and acc are bf16 (else f32), and then scale must
// already be a bf16 value. The split plan (num_chunks = 0: none): the
// split rows (ascending), each one's chunks chunk_ptr[i] : chunk_ptr[i + 1],
// each chunk's split-row index and first edge, the cap; partial is f32
// [num_chunks, num_features] scratch and counters int32 [split rows],
// zero before the launch.
extern "C" int csr_spmm_prop(const int32_t* indptr, const int32_t* indices,
                             const float* values, const void* x, void* y,
                             void* acc, int num_rows, int num_features,
                             float scale, int accumulate, int term_bf16,
                             int carry_bf16, const int32_t* split_rows,
                             const int32_t* chunk_ptr,
                             const int32_t* chunk_row,
                             const int32_t* chunk_lo, int num_chunks, int cap,
                             float* partial, int* counters, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  if (num_chunks > 0 && cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fn = carry_bf16 ? (term_bf16 ? launch<true, __nv_bfloat16>
                                    : launch<false, __nv_bfloat16>)
                       : (term_bf16 ? launch<true, float>
                                    : launch<false, float>);
  return fn(indptr, indices, values, x, y, acc, num_rows, num_features, scale,
            accumulate, split_rows, chunk_ptr, chunk_row, chunk_lo,
            num_chunks, cap, partial, counters, s);
}
