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
// What bounds it on an H100: latency, then bytes. A MAG train step (R = 40
// rows, Ktop = 32, P = 24, H = 64, K = 2) gathers 30,720 table rows of
// 256 B, 7.9 MB, 2.4 us at the HBM's rate; each of those rows is at the end
// of a chain of three dependent loads (tk_cols -> the node's attr row -> the
// table row), and then the sums meet. The eval form (240 rows) and the node
// form (10,000 nodes a launch) gather 47 and 61 MB: bytes bound them. The
// node form over 1M nodes gathers 24M rows from a 712 MB table that the
// 50 MB L2 barely caches.
//
// Forward (redesigned for the H100). A block takes one batch row (or, for
// Ktop < 4, enough rows for 4 warps; in the node form 4 nodes) and gives
// each top-k slot a warp of its own: up to 32 warps a row, a warp walking
// ceil(Ktop / 32) slots, so each warp's chain is one slot long at the
// preset's Ktop 32. A warp loads its slot's node id, weights and keep bits
// together, then the node's P ids and values (one a lane), drops the
// padding and the ids outside the vocab window with a ballot, compacts the
// rest into a per-warp list in shared memory, and issues the list's table
// rows 4 at a time a lane group into registers before any multiply: lane
// groups of L lanes cover one row (float4 a lane where H is a multiple of
// 4 and the table aligned, L = 16 at H = 64, so one warp load fetches two
// rows; otherwise one float a lane), the groups taking every G-th id. The
// groups' partial sums meet by a fixed xor-shuffle tree, each warp adds its
// slots' w * num / S into its own shared-memory row, and after one barrier
// the block sums the warps' rows in slot order and divides by D. No float
// atomics: the output is the same bits on every run. The block's weights
// for D are written after the gathers are issued, so no slot's chain waits
// on them. The input-dropout mask is read as the lane's 4 bytes (its 4
// features) with one 32-bit load a (k, id), issued with the batch's table
// rows; the earlier kernel read one byte a feature. A 16-byte read would
// need a lane to hold 16 features of an id and K x 16 partial sums, more
// registers than a 1,024-thread block has (64 a thread), and the mask is
// off the main path (the MAG preset's input dropout is 0). D is summed
// serially over the slots from the block's shared weights, and S by the
// warp in attr_mass's order, as the backward sums them.
//
// Forward, what was tried and not kept (device time in ms, train / eval /
// node form / a window; NVIDIA H100 80GB HBM3, 700 W; tools/
// propagation_times.py k3, PERF.md section 6): 8 rows in flight a
// lane group 0.0083 / 0.0256 / 0.0300 / 0.0059 (24-48 bytes spilled), 12
// rows 0.0095 / 0.0314 / 0.0388 / 0.0065 (124-140 bytes spilled), 6 rows
// 0.0076 / 0.0245 / 0.0284 / 0.0056 (12 bytes spilled), against 4 rows
// 0.0085 / 0.0235 / 0.0281 / 0.0057 (kept: no spill; the node form, 200
// launches on the paths, weighs most); 16 warps a block (a warp two
// slots, 128 registers, 12 rows in flight) 0.0091 / 0.0254 / 0.0300 /
// 0.0066; rows a block for 8 warps instead of 4: the node form 2.4 %
// slower; the mask words loaded inside the multiply loop: train with
// input dropout 0.0245, against 0.0187 issued with the table rows.
//
// Backward (not redesigned): one warp per (row, slot), lanes over H with two
// floats a lane, one atomicAdd per table element touched, into a dense
// [V, H] gradient that the caller zero-fills (the fill is most of its time:
// dense Adam reads the whole gradient, so the bound counts it too). Both
// use 64-bit offsets into the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // backward block
constexpr int kChunk = 64;      // backward: h values per pass, two per lane
constexpr int kMaxWarps = 32;   // forward: warps a block at most (one a slot)
constexpr int kMinWarps = 4;    // forward: rows a block fill this many warps
constexpr int kIdBytes = 3 * 32 * 4;   // forward: a warp's compacted id list
constexpr int kMaxSmem = 232448;       // an H100 block's shared memory

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// sum_p attr_vals[p] over a row of P values, by the whole warp: each lane
// adds its values p = lane, lane + 32, ... in order, then warp_sum. The
// forward forms the lanes' shares in the same order, so the forward and the
// backward see the same S bit for bit.
__device__ __forceinline__ float attr_mass(const float* __restrict__ av, int P,
                                           int lane) {
  float s = 0.0f;
  for (int p = lane; p < P; p += 32) s += av[p];
  return warp_sum(s);
}

// kF neighbouring features of a table row (kF = 4: one 16-byte load).
__device__ __forceinline__ void load_row(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The drop-mask bytes of kF neighbouring features, byte e for feature e
// (kF = 4: one 32-bit load).
template <int kF>
__device__ __forceinline__ unsigned load_mask(const uint8_t* p) {
  if constexpr (kF == 4) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    return __ldg(p);
  }
}

// The forward. Shared memory: red [warps][K][chunk] (each warp's partial
// sums of one feature chunk), w [rows a block][K][ktop], then each warp's
// compacted id list (ids - lo, values, attribute slots).
template <int K, bool DROP, int kF>
__global__ void __launch_bounds__(kMaxWarps * 32) embed_prop_fwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ attr_cols,
    const float* __restrict__ attr_vals, const int32_t* __restrict__ tk_cols,
    const float* __restrict__ tk_vals, const uint8_t* __restrict__ keep,
    const uint8_t* __restrict__ drop, float* __restrict__ out, int rows,
    int ktop, int P, int H, float keep_prob, int wpr, int lanes_log2,
    int vocab_lo, int vocab_hi) {
  constexpr int NK = DROP ? K : 1;               // one sum when nothing drops
  // table rows a lane group gathers before it multiplies: 4 (8 or 12
  // spilled under the 64 registers a thread of a 1,024-thread block has,
  // and were slower); 2 with input dropout at K > 2, whose mask words and
  // K sums also hold registers
  constexpr int kU = DROP && K > 2 ? 2 : 4;
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int rpb = nwarps / wpr;                  // rows per block
  const int L = 1 << lanes_log2, G = 32 >> lanes_log2;
  const int chunk = L * kF;                      // features a pass
  float* red = smem;
  float* w = red + nwarps * K * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ids = reinterpret_cast<int*>(w + rpb * K * ktop) + warp * 96;
  float* vals = reinterpret_cast<float*>(ids + 32);
  int* slots = ids + 64;
  const int li = lane & (L - 1), grp = lane >> lanes_log2;
  const int row0 = blockIdx.x * rpb;
  const int rr = warp / wpr, sub = warp - rr * wpr;
  const int r = row0 + rr;
  const bool node_form = tk_cols == nullptr;

  for (int h0 = 0; h0 < H; h0 += chunk) {
    const int h = h0 + li * kF;                  // this lane's first feature
    float* wred = red + warp * K * chunk;
    for (int i = lane; i < K * chunk; i += 32) wred[i] = 0.0f;
    __syncwarp();
    for (int j = sub; r < rows && j < ktop; j += wpr) {
      const int64_t slot = static_cast<int64_t>(r) * ktop + j;
      // the slot's node and weights, loaded together
      const int64_t node = node_form ? r : __ldg(tk_cols + slot);
      const float tv = node_form ? 1.0f : __ldg(tk_vals + slot);
      float wk[K];
      bool any = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool kept = keep == nullptr ||
                          keep[(static_cast<int64_t>(k) * rows + r) * ktop + j] != 0;
        wk[k] = kept ? tv : 0.0f;
        any |= wk[k] != 0.0f;
      }
      if (!any) continue;                        // warp-uniform
      const int32_t* ac = attr_cols + node * P;
      const float* av = attr_vals + node * P;
      float s = 0.0f;                            // this lane's share of S
      float num[NK][kF];
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int e = 0; e < kF; ++e) num[k][e] = 0.0f;
      for (int p0 = 0; p0 < P; p0 += 32) {
        const int p = p0 + lane;
        int32_t c = 0;
        float a = 0.0f;
        if (p < P) {
          c = __ldg(ac + p);
          a = __ldg(av + p);
          s += a;
        }
        // padding, or an id outside the window: no gather
        const bool live = a != 0.0f && c >= vocab_lo && c < vocab_hi;
        const unsigned m = __ballot_sync(kFull, live);
        const int n = __popc(m);
        if (live) {
          const int at = __popc(m & ((1u << lane) - 1u));
          ids[at] = c - vocab_lo;
          vals[at] = a;
          slots[at] = p;
        }
        __syncwarp();
        for (int i0 = grp; i0 < n; i0 += G * kU) {
          // the batch's table rows (and mask words) all issued before any
          // multiply
          float v[kU][kF];
          unsigned dm[kU][NK];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int i = i0 + G * u;
            if (i < n && h < H) {
              load_row(table + static_cast<int64_t>(ids[i]) * H + h, v[u]);
            } else {
#pragma unroll
              for (int e = 0; e < kF; ++e) v[u][e] = 0.0f;
            }
          }
          if constexpr (DROP) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int i = i0 + G * u;
#pragma unroll
              for (int k = 0; k < K; ++k) {
                const int64_t kslot = (static_cast<int64_t>(k) * rows + r) *
                                          ktop + j;
                dm[u][k] = i < n && h < H
                    ? load_mask<kF>(drop + (kslot * P + slots[i]) * H + h)
                    : 0u;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int i = i0 + G * u;
            if (i >= n) break;
            const float ai = vals[i];
            if constexpr (!DROP) {
#pragma unroll
              for (int e = 0; e < kF; ++e) {
                num[0][e] = fmaf(ai, v[u][e], num[0][e]);
              }
            } else {
#pragma unroll
              for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int e = 0; e < kF; ++e) {
                  const bool de = (dm[u][k] >> (8 * e)) & 0xffu;
                  num[k][e] = fmaf(ai, de ? v[u][e] / keep_prob : 0.0f,
                                   num[k][e]);
                }
              }
            }
          }
        }
        __syncwarp();                            // before the next list
      }
      const float S = warp_sum(s) + 1e-10f;
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int e = 0; e < kF; ++e)
          for (int o = L; o < 32; o <<= 1)
            num[k][e] += __shfl_xor_sync(kFull, num[k][e], o);
      if (grp == 0 && h < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float* dst = wred + k * chunk + li * kF;
#pragma unroll
          for (int e = 0; e < kF; ++e) {
            dst[e] = fmaf(wk[k], num[DROP ? k : 0][e] / S, dst[e]);
          }
        }
      }
    }
    if (h0 == 0) {
      // w[k, r, j] for D, after the gathers so that no slot's loads wait
      // on it (its loads hit the lines the warps' own weights brought in)
      for (int i = threadIdx.x; i < rpb * ktop; i += blockDim.x) {
        const int rr2 = i / ktop, j = i - rr2 * ktop;
        const int r2 = row0 + rr2;
        const bool live = r2 < rows;
        const float v = !live ? 0.0f
                              : (node_form ? 1.0f
                                           : tk_vals[static_cast<int64_t>(r2) * ktop + j]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool kept =
              keep == nullptr ||
              (live && keep[(static_cast<int64_t>(k) * rows + r2) * ktop + j] != 0);
          w[(rr2 * K + k) * ktop + j] = kept ? v : 0.0f;
        }
      }
    }
    __syncthreads();
    // the warps' partial sums in slot order, over D
    for (int i = threadIdx.x; i < rpb * K * chunk; i += blockDim.x) {
      const int rr2 = i / (K * chunk);
      const int rem = i - rr2 * K * chunk;
      const int k = rem / chunk, hh = rem - k * chunk;
      const int r2 = row0 + rr2, hc = h0 + hh;
      if (r2 >= rows || hc >= H) continue;
      float sum = 0.0f;
      for (int sb = 0; sb < wpr; ++sb)
        sum += red[((rr2 * wpr + sb) * K + k) * chunk + hh];
      if (node_form) {
        out[(static_cast<int64_t>(k) * rows + r2) * H + hc] = sum;
      } else {
        const float* wr = w + (rr2 * K + k) * ktop;
        float d = 0.0f;
        for (int jj = 0; jj < ktop; ++jj) d += wr[jj];
        out[(static_cast<int64_t>(k) * rows + r2) * H + hc] =
            sum / (d + 1e-12f);
      }
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

// The forward's launch: warps a row (one a slot, up to 32), rows a block
// (enough for 4 warps), the lanes of a row group (a power of two: H / kF
// rounded up, at most 16 float4 lanes or 32 float lanes) and the dynamic
// shared memory. sparse_input.py's _check_args mirrors the memory with
// chunk 64, the most either path takes.
struct FwdConfig {
  int wpr, rpb, lanes_log2, chunk;
  size_t smem;
};

inline FwdConfig fwd_config(int ktop, int H, int K, int kF) {
  FwdConfig c;
  c.wpr = ktop < kMaxWarps ? ktop : kMaxWarps;
  c.rpb = c.wpr >= kMinWarps ? 1 : (kMinWarps + c.wpr - 1) / c.wpr;
  const int lanes_max = kF == 4 ? 16 : 32;
  const int need = (H + kF - 1) / kF;
  c.lanes_log2 = 0;
  while ((1 << c.lanes_log2) < need && (1 << c.lanes_log2) < lanes_max)
    ++c.lanes_log2;
  c.chunk = (1 << c.lanes_log2) * kF;
  const int nwarps = c.rpb * c.wpr;
  c.smem = static_cast<size_t>(nwarps * K * c.chunk + c.rpb * K * ktop) *
               sizeof(float) +
           static_cast<size_t>(nwarps) * kIdBytes;
  return c;
}

template <int K, bool DROP>
cudaError_t launch_fwd(const float* table, const int32_t* attr_cols,
                       const float* attr_vals, const int32_t* tk_cols,
                       const float* tk_vals, const uint8_t* keep,
                       const uint8_t* drop, float* out, int rows, int ktop,
                       int P, int H, float keep_prob, int vocab_lo,
                       int vocab_hi, cudaStream_t stream) {
  const bool vec = H % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(drop) % 4 == 0;
  const FwdConfig c = fwd_config(ktop, H, K, vec ? 4 : 1);
  if (c.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kernel = vec ? embed_prop_fwd_kernel<K, DROP, 4>
                    : embed_prop_fwd_kernel<K, DROP, 1>;
  if (c.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(c.smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + c.rpb - 1) / c.rpb;
  kernel<<<blocks, c.rpb * c.wpr * 32, c.smem, stream>>>(
      table, attr_cols, attr_vals, tk_cols, tk_vals, keep, drop, out, rows,
      ktop, P, H, keep_prob, c.wpr, c.lanes_log2, vocab_lo, vocab_hi);
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
