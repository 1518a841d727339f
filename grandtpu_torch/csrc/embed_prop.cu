// K3: embedding-bag + DropNode weighted mean for the sparse-feature (MAG)
// engine, forward and backward.
//
// Replaces the TPU program grandtpu/nn/sparse_input.py::embed_nodes (an
// attr-value-weighted mean of embedding rows with per-element inverted
// dropout) and its jnp.take transpose (a scatter-add into the table), fused
// with grandtpu/nn/dropnode.py::random_prop as MAG forward_k runs them
// (grandtpu/train/trainer_sparse.py:46-84). With r a batch row, j a top-k
// slot, p an attribute slot, k an augmentation:
//
//   node       = tk_cols[r, j]            (node form, tk_cols == nullptr: r)
//   c, a       = attr_cols[node, p], attr_vals[node, p]
//   S          = sum_p a + 1e-10          (undropped values)
//   E[k,r,j,h] = sum_p a * (drop ? drop[k,r,j,p,h] / keep_prob : 1) * T[c, h] / S
//   w[k,r,j]   = keep[k,r,j] ? tk_vals[r, j] : 0   (keep == nullptr: all kept)
//   D[k,r]     = sum_j w[k,r,j] + 1e-12
//   out[k,r,h] = sum_j w[k,r,j] * E[k,r,j,h] / D[k,r]  (node form: E[k,r,0,h])
//
// The backward scatter-adds into a zeroed dense dT [V, H] with float
// atomics:  dT[c, h] += sum_k g[k,r,h] / D[k,r] * w[k,r,j] / S * a * drop/keep_prob.
//
// Vocab window [lo, hi) (the vocab-sharded table of data-parallel training,
// grandtpu/dist/data_parallel.py:96-150): T holds rows lo..hi-1 only. The
// forward adds only the terms whose id c lies in the window, reading
// T[c - lo]; the backward adds only those, into a [hi - lo, H] gradient. S
// stays the whole row's attr mass and D does not depend on the table, so
// the windows' forwards sum to the full forward and their gradients
// concatenate to the full gradient. lo = 0, hi = V is the unsharded call,
// bit for bit (the window test never skips a term).
//
// What bounds it on an H100: bytes, and mostly the gathers. A MAG train step
// (R = 40 rows, Ktop = 32, P = 24, H = 64) gathers 30,720 table rows of
// 256 B; the node form over 1M nodes gathers 24M rows from a 712 MB table
// that the 50 MB L2 barely caches. So the design reads each gathered table
// row once for all K augmentations (K accumulators per lane in registers),
// resolves the tk_cols -> attr_cols double indirection inside the kernel (the
// [R, Ktop, P] id and value blocks are never written to device memory),
// skips zero-weight slots (top-k and attribute padding), and uses 64-bit
// offsets into the table. Forward: warps of a block split one row's top-k
// slots (or take one node each in the node form), lanes stride over H with
// two floats a lane, and the warps' partial sums meet in shared memory.
// Backward: one warp per (row, slot), lanes over H, one atomicAdd per table
// element touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kChunk = 64;   // h values per pass: two per lane

// sum_p attr_vals[p] over a row of P values, by the whole warp. The forward
// and the backward call this same code, so both see the same S bit for bit.
__device__ __forceinline__ float attr_mass(const float* __restrict__ av, int P,
                                           int lane) {
  float s = 0.0f;
  for (int p = lane; p < P; p += 32) s += av[p];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

template <int K, bool DROP>
__global__ void __launch_bounds__(kThreads) embed_prop_fwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ attr_cols,
    const float* __restrict__ attr_vals, const int32_t* __restrict__ tk_cols,
    const float* __restrict__ tk_vals, const uint8_t* __restrict__ keep,
    const uint8_t* __restrict__ drop, float* __restrict__ out, int rows,
    int ktop, int P, int H, float keep_prob, int wpr, int vocab_lo,
    int vocab_hi) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int rpb = nwarps / wpr;                 // rows per block
  float* w = smem;                              // [rpb][K][ktop]
  float* den = w + rpb * K * ktop;              // [rpb][K]
  float* red = den + rpb * K;                   // [nwarps][K][kChunk]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rpb;
  const bool node_form = tk_cols == nullptr;

  for (int i = threadIdx.x; i < rpb * ktop; i += blockDim.x) {
    const int rr = i / ktop, j = i - rr * ktop;
    const int r = row0 + rr;
    const bool live = r < rows;
    const float v =
        !live ? 0.0f : (node_form ? 1.0f : tk_vals[static_cast<int64_t>(r) * ktop + j]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool kept =
          keep == nullptr ||
          (live && keep[(static_cast<int64_t>(k) * rows + r) * ktop + j] != 0);
      w[(rr * K + k) * ktop + j] = kept ? v : 0.0f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rpb * K; i += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < ktop; ++j) s += w[i * ktop + j];
    den[i] = s + 1e-12f;
  }
  __syncthreads();

  const int rr = warp / wpr, sub = warp - rr * wpr;
  const int r = row0 + rr;
  for (int h0 = 0; h0 < H; h0 += kChunk) {
    const int ha = h0 + lane, hb = h0 + 32 + lane;
    float acc[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k][0] = acc[k][1] = 0.0f;
    if (r < rows) {
      for (int j = sub; j < ktop; j += wpr) {
        const float* wj = w + rr * K * ktop + j;   // w[k] at wj[k * ktop]
        bool any = false;
#pragma unroll
        for (int k = 0; k < K; ++k) any |= wj[k * ktop] != 0.0f;
        if (!any) continue;                        // warp-uniform
        const int64_t node =
            node_form ? r : tk_cols[static_cast<int64_t>(r) * ktop + j];
        const int32_t* ac = attr_cols + node * P;
        const float* av = attr_vals + node * P;
        const float s = attr_mass(av, P, lane) + 1e-10f;
        constexpr int NK = DROP ? K : 1;           // one sum when nothing drops
        float num[NK][2];
#pragma unroll
        for (int k = 0; k < NK; ++k) num[k][0] = num[k][1] = 0.0f;
        for (int p0 = 0; p0 < P; p0 += 32) {
          const int pl = p0 + lane;
          const int32_t c_l = pl < P ? ac[pl] : 0;
          const float a_l = pl < P ? av[pl] : 0.0f;
          const int np = min(32, P - p0);
#pragma unroll 4
          for (int q = 0; q < np; ++q) {
            const int64_t c = __shfl_sync(kFull, c_l, q);
            const float a = __shfl_sync(kFull, a_l, q);
            // padding, or an id outside the window; warp-uniform
            if (a == 0.0f || c < vocab_lo || c >= vocab_hi) continue;
            const float* trow = table + (c - vocab_lo) * H;
            const float ta = ha < H ? __ldg(trow + ha) : 0.0f;
            const float tb = hb < H ? __ldg(trow + hb) : 0.0f;
            if (!DROP) {
              num[0][0] = fmaf(a, ta, num[0][0]);
              num[0][1] = fmaf(a, tb, num[0][1]);
            } else {
#pragma unroll
              for (int k = 0; k < NK; ++k) {
                const uint8_t* dk =
                    drop + ((((static_cast<int64_t>(k) * rows + r) * ktop + j) * P +
                             p0 + q) * H);
                const bool da = ha < H && dk[ha] != 0;
                const bool db = hb < H && dk[hb] != 0;
                num[k][0] = fmaf(a, da ? ta / keep_prob : 0.0f, num[k][0]);
                num[k][1] = fmaf(a, db ? tb / keep_prob : 0.0f, num[k][1]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int kk = DROP ? k : 0;
          acc[k][0] = fmaf(wj[k * ktop], num[kk][0] / s, acc[k][0]);
          acc[k][1] = fmaf(wj[k * ktop], num[kk][1] / s, acc[k][1]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      red[(warp * K + k) * kChunk + lane] = acc[k][0];
      red[(warp * K + k) * kChunk + 32 + lane] = acc[k][1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rpb * K * kChunk; i += blockDim.x) {
      const int rr2 = i / (K * kChunk);
      const int rem = i - rr2 * K * kChunk;
      const int k = rem / kChunk, hh = rem - k * kChunk;
      const int r2 = row0 + rr2, h = h0 + hh;
      if (r2 >= rows || h >= H) continue;
      float s = 0.0f;
      for (int sb = 0; sb < wpr; ++sb)
        s += red[((rr2 * wpr + sb) * K + k) * kChunk + hh];
      out[(static_cast<int64_t>(k) * rows + r2) * H + h] =
          node_form ? s : s / den[rr2 * K + k];
    }
    __syncthreads();
  }
}

template <int K, bool DROP>
__global__ void __launch_bounds__(kThreads) embed_prop_bwd_kernel(
    const float* __restrict__ grad, const int32_t* __restrict__ attr_cols,
    const float* __restrict__ attr_vals, const int32_t* __restrict__ tk_cols,
    const float* __restrict__ tk_vals, const uint8_t* __restrict__ keep,
    const uint8_t* __restrict__ drop, float* __restrict__ dtable, int rows,
    int ktop, int P, int H, float keep_prob, int vocab_lo, int vocab_hi) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  if (gw >= static_cast<int64_t>(rows) * ktop) return;   // whole warp
  const int r = static_cast<int>(gw / ktop);
  const int j = static_cast<int>(gw - static_cast<int64_t>(r) * ktop);
  const bool node_form = tk_cols == nullptr;

  // w[k,r,j] and D[k,r], summed in the forward's order (serial over j)
  float wk[K], dk[K];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (node_form) {
      wk[k] = 1.0f;
      dk[k] = 1.0f;
    } else {
      float d = 0.0f, wj = 0.0f;
      for (int jj = 0; jj < ktop; ++jj) {
        const float v = tk_vals[static_cast<int64_t>(r) * ktop + jj];
        const bool kept =
            keep == nullptr ||
            keep[(static_cast<int64_t>(k) * rows + r) * ktop + jj] != 0;
        const float wv = kept ? v : 0.0f;
        d += wv;
        if (jj == j) wj = wv;
      }
      wk[k] = wj;
      dk[k] = d + 1e-12f;
    }
    any |= wk[k] != 0.0f;
  }
  if (!any) return;                                      // whole warp

  const int64_t node =
      node_form ? r : tk_cols[static_cast<int64_t>(r) * ktop + j];
  const int32_t* ac = attr_cols + node * P;
  const float* av = attr_vals + node * P;
  const float s = attr_mass(av, P, lane) + 1e-10f;

  for (int h0 = 0; h0 < H; h0 += kChunk) {
    const int ha = h0 + lane, hb = h0 + 32 + lane;
    // dL/dnum of E: g / D * w / S, per augmentation
    float gn[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* gk = grad + (static_cast<int64_t>(k) * rows + r) * H;
      const float ga = ha < H ? gk[ha] : 0.0f;
      const float gb = hb < H ? gk[hb] : 0.0f;
      gn[k][0] = ga / dk[k] * wk[k] / s;
      gn[k][1] = gb / dk[k] * wk[k] / s;
    }
    float tot[2] = {0.0f, 0.0f};
    if (!DROP) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        tot[0] += gn[k][0];
        tot[1] += gn[k][1];
      }
    }
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int pl = p0 + lane;
      const int32_t c_l = pl < P ? ac[pl] : 0;
      const float a_l = pl < P ? av[pl] : 0.0f;
      const int np = min(32, P - p0);
      for (int q = 0; q < np; ++q) {
        const int64_t c = __shfl_sync(kFull, c_l, q);
        const float a = __shfl_sync(kFull, a_l, q);
        if (a == 0.0f || c < vocab_lo || c >= vocab_hi) continue;  // uniform
        float va = tot[0], vb = tot[1];
        if (DROP) {
          va = vb = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const uint8_t* dmask =
                drop + ((((static_cast<int64_t>(k) * rows + r) * ktop + j) * P +
                         p0 + q) * H);
            if (ha < H && dmask[ha] != 0) va += gn[k][0] / keep_prob;
            if (hb < H && dmask[hb] != 0) vb += gn[k][1] / keep_prob;
          }
        }
        float* trow = dtable + (c - vocab_lo) * H;
        if (ha < H) atomicAdd(trow + ha, va * a);
        if (hb < H) atomicAdd(trow + hb, vb * a);
      }
    }
  }
}

// Smallest warps-per-row that covers ktop up to 8; rows per block fill the
// remaining warps of the 256-thread block.
inline int warps_per_row(int ktop) { return ktop < 8 ? ktop : 8; }

template <int K, bool DROP>
cudaError_t launch_fwd(const float* table, const int32_t* attr_cols,
                       const float* attr_vals, const int32_t* tk_cols,
                       const float* tk_vals, const uint8_t* keep,
                       const uint8_t* drop, float* out, int rows, int ktop,
                       int P, int H, float keep_prob, int vocab_lo,
                       int vocab_hi, cudaStream_t stream) {
  const int wpr = warps_per_row(ktop);
  const int rpb = (kThreads / 32) / wpr;
  const int threads = rpb * wpr * 32;
  const size_t smem =
      static_cast<size_t>(rpb * K * ktop + rpb * K + rpb * wpr * K * kChunk) *
      sizeof(float);
  const int blocks = (rows + rpb - 1) / rpb;
  embed_prop_fwd_kernel<K, DROP><<<blocks, threads, smem, stream>>>(
      table, attr_cols, attr_vals, tk_cols, tk_vals, keep, drop, out, rows,
      ktop, P, H, keep_prob, wpr, vocab_lo, vocab_hi);
  return cudaGetLastError();
}

template <int K, bool DROP>
cudaError_t launch_bwd(const float* grad, const int32_t* attr_cols,
                       const float* attr_vals, const int32_t* tk_cols,
                       const float* tk_vals, const uint8_t* keep,
                       const uint8_t* drop, float* dtable, int rows, int ktop,
                       int P, int H, float keep_prob, int vocab_lo,
                       int vocab_hi, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(rows) * ktop;
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  embed_prop_bwd_kernel<K, DROP><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   stream>>>(
      grad, attr_cols, attr_vals, tk_cols, tk_vals, keep, drop, dtable, rows,
      ktop, P, H, keep_prob, vocab_lo, vocab_hi);
  return cudaGetLastError();
}

#define EMBED_PROP_DISPATCH(LAUNCH, ...)                                   \
  switch (num_aug * 2 + (drop != nullptr)) {                               \
    case 2: return LAUNCH<1, false>(__VA_ARGS__);                          \
    case 3: return LAUNCH<1, true>(__VA_ARGS__);                           \
    case 4: return LAUNCH<2, false>(__VA_ARGS__);                          \
    case 5: return LAUNCH<2, true>(__VA_ARGS__);                           \
    case 6: return LAUNCH<3, false>(__VA_ARGS__);                          \
    case 7: return LAUNCH<3, true>(__VA_ARGS__);                           \
    case 8: return LAUNCH<4, false>(__VA_ARGS__);                          \
    case 9: return LAUNCH<4, true>(__VA_ARGS__);                           \
    case 10: return LAUNCH<5, false>(__VA_ARGS__);                         \
    case 11: return LAUNCH<5, true>(__VA_ARGS__);                          \
    case 12: return LAUNCH<6, false>(__VA_ARGS__);                         \
    case 13: return LAUNCH<6, true>(__VA_ARGS__);                          \
    case 14: return LAUNCH<7, false>(__VA_ARGS__);                         \
    case 15: return LAUNCH<7, true>(__VA_ARGS__);                          \
    case 16: return LAUNCH<8, false>(__VA_ARGS__);                         \
    case 17: return LAUNCH<8, true>(__VA_ARGS__);                          \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

}  // namespace

// Both return the cudaError_t of the launch (0 on success). num_aug is K,
// 1..8. tk_cols == nullptr selects the node form (ktop must be 1, tk_vals
// and keep null); keep == nullptr keeps every slot; drop == nullptr applies
// no input dropout (keep_prob is then unused). table (and dtable) hold the
// rows [vocab_lo, vocab_hi) of the vocabulary; 0 and V for the whole
// table. The backward adds into dtable, which the caller zeroes.
extern "C" int embed_prop_fwd_f32(const float* table, const int32_t* attr_cols,
                                  const float* attr_vals,
                                  const int32_t* tk_cols, const float* tk_vals,
                                  const uint8_t* keep, const uint8_t* drop,
                                  float* out, int rows, int ktop, int P, int H,
                                  int num_aug, float keep_prob, int vocab_lo,
                                  int vocab_hi, void* stream) {
  if (rows == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EMBED_PROP_DISPATCH(launch_fwd, table, attr_cols, attr_vals, tk_cols,
                      tk_vals, keep, drop, out, rows, ktop, P, H, keep_prob,
                      vocab_lo, vocab_hi, s)
}

extern "C" int embed_prop_bwd_f32(const float* grad, const int32_t* attr_cols,
                                  const float* attr_vals,
                                  const int32_t* tk_cols, const float* tk_vals,
                                  const uint8_t* keep, const uint8_t* drop,
                                  float* dtable, int rows, int ktop, int P,
                                  int H, int num_aug, float keep_prob,
                                  int vocab_lo, int vocab_hi, void* stream) {
  if (rows == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EMBED_PROP_DISPATCH(launch_bwd, grad, attr_cols, attr_vals, tk_cols,
                      tk_vals, keep, drop, dtable, rows, ktop, P, H,
                      keep_prob, vocab_lo, vocab_hi, s)
}
