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
// The backward scatter-adds into a zeroed dense dT [V, H], in a fixed
// order:  dT[c, h] += sum_k g[k,r,h] / D[k,r] * w[k,r,j] / S * a * drop/keep_prob.
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
// Backward (redesigned for the H100), deterministic: the same bits on every
// run, so that a training run repeats itself and a CUDA-graph replay of
// steps equals the steps run eagerly. Each table row's gradient is the sum,
// from 0.0f and in entry order, of the term rows of its id's (row, slot,
// attribute) entries (E = rows x ktop x P of them): the bits of the earlier
// backward, which wrote every term row to a scratch [E, H], ordered the ids
// with a stable torch.sort and added each run of equal ids in a second
// kernel. Now one host call, embed_prop_bwd_f32, launches four kernels on
// the stream and nothing else: no sort, no fill or allocation of PyTorch's.
//   1. terms: a warp a (row, slot) writes the slot's term vector (the sum
//      over k of g / D * w / S, or with input dropout each k's share over
//      keep_prob) and each entry's id and value; the grid's other blocks
//      zero-fill the dense [hi - lo, H] gradient, 16-byte stores in one pass
//      (the fill is most of the time: dense Adam reads the whole gradient,
//      so the bound counts it too), under which the warps' chains of
//      dependent loads run.
//   2. count: each live entry takes a rank among its id's entries with an
//      integer atomicAdd on the first word of its id's gradient row (zeroed
//      by the fill, so no [V] array; one atomicAdd for a warp's entries of
//      one id) and, below the row's capacity (31 at H = 64), writes itself
//      and its value into the row; each id's first entry lists the id.
//   3. sum: a warp an id listed. An id of up to that many entries is summed
//      from its row: each lane's entry is put in entry order by its rank
//      among the lanes', and its terms are added in that order into the
//      row. A longer id is listed as long.
//   4. long: a block a long id reads the entries' ids in entry order (8
//      consecutive ones a thread, 2,048 a round), lists the id's entries
//      with their slots and values as it meets them, forms each tile of 64
//      entries' terms in shared memory and adds them in order, one thread a
//      feature.
// The ranks follow the atomics' timing; the order of the adds does not. A
// term is formed again where it is added (the slot's vector times the
// value), each multiply and add rounded on its own (no FMA contraction), so
// the scratch holds [rows x ktop, K, H] vectors and four words an entry,
// not [E, H] rows. What bounds it: the fill's 712 MB at the MAG table
// (0.2125 ms at 3.35 TB/s); the rest is four launches of latency-bound
// chains, and an id of many entries adds them one after another. Before the
// sort, the backward added each term with a float atomicAdd, in an order
// that changed from run to run. 64-bit offsets.
//
// Backward, what was tried and not kept (device ms a call, every operation,
// MAG train / eval / one id for every entry; NVIDIA H100 80GB HBM3, 700 W;
// tools/propagation_times.py k3 and a per-kernel profile): five launches,
// each id's entries placed in a scratch [E] by one atomicAdd a warp on a
// shared counter, a bitmap of entry indices ordering a long id, 0.254 /
// 0.353 / 2.13; the same with ids' first entries in their rows, the
// fill as a grid-stride loop (3.15 TB/s, against 3.27 in one pass), 0.244
// train; a long id summed a round of 4,096 ids at a time, its terms' slots
// divided out in every tile, 0.234 / 0.309 / 1.27; kept 0.234 / 0.309 /
// 0.92 (the sorting backward: 0.274 / 0.352 / 6.14).

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
constexpr int kShortSeg = 32;          // backward: a warp sums up to this many
constexpr int kMaxSumBlocks = 132 * 8;
constexpr int kMaxLongBlocks = 132 * 2;
constexpr int kFillVecs = 4;          // backward fill: float4 stores a thread
constexpr int kTile = 64;              // long ids: entries a tile of terms

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

// The backward's scratch, carved from one buffer that the caller allocates
// (embed_prop_bwd_scratch gives its size): S = rows x ktop slots, E = S x P
// entries, NK = K with input dropout, else 1; each array 16-byte aligned.
struct BwdScratch {
  float* sv;    // [S, NK, H] each live slot's term vector(s)
  int* key;     // [E] a live entry's id - lo; -1 for an entry adding nothing
  float* val;   // [E] the entry's attribute value
  int* lead;    // [E] the ids present (id - lo), one item an id
  int* longs;   // [E] the ids with more entries than their row holds
  int* ctr;     // [4] ids present, long ids
};

inline int64_t pad4(int64_t n) { return (n + 3) / 4 * 4; }

inline int64_t bwd_scratch_words(int rows, int ktop, int P, int H, int nk) {
  const int64_t S = static_cast<int64_t>(rows) * ktop, E = S * P;
  return pad4(S * nk * H) + 4 * pad4(E) + 4;
}

inline BwdScratch carve_scratch(void* buf, int rows, int ktop, int P, int H,
                                int nk) {
  const int64_t S = static_cast<int64_t>(rows) * ktop, E = S * P;
  int* w = static_cast<int*>(buf);
  BwdScratch s;
  s.sv = reinterpret_cast<float*>(w);
  w += pad4(S * nk * H);
  s.key = w;
  w += pad4(E);
  s.val = reinterpret_cast<float*>(w);
  w += pad4(E);
  s.lead = w;
  w += pad4(E);
  s.longs = w;
  w += pad4(E);
  s.ctr = w;
  return s;
}

// Entries an id's own gradient row holds until its sum overwrites it: word 0
// counts the id's entries, words 1 + 2r and 2 + 2r hold the entry of rank r
// and its attribute value, for r < cap. An id with at most cap entries is
// summed by one warp from its row alone, a longer one by a block that scans
// the entries' ids.
__host__ __device__ __forceinline__ int row_cap(int H) {
  return (H - 1) / 2 < kShortSeg ? (H - 1) / 2 : kShortSeg;
}

__device__ __forceinline__ int* id_word(float* dtable, int cl, int H) {
  return reinterpret_cast<int*>(dtable + static_cast<int64_t>(cl) * H);
}

// Launch 1. Blocks [0, term_blocks): a warp a (row, slot), lanes over H with
// two floats a lane: the slot's weights and D (summed serially over the
// slots, the forward's order) and S (attr_mass), then its term vector into
// sv (without input dropout sum_k g / D * w / S, in k order from 0.0f; with
// it each k's g / D * w / S / keep_prob), and each entry's id and value.
// The other blocks zero-fill the gradient [len] and the counters.
template <int K, bool DROP>
__global__ void __launch_bounds__(kThreads) embed_prop_bwd_terms_kernel(
    const float* __restrict__ grad, const int32_t* __restrict__ attr_cols,
    const float* __restrict__ attr_vals, const int32_t* __restrict__ tk_cols,
    const float* __restrict__ tk_vals, const uint8_t* __restrict__ keep,
    float* __restrict__ dtable, int64_t len, BwdScratch sc, int term_blocks,
    int rows, int ktop, int P, int H, float keep_prob, int vocab_lo,
    int vocab_hi) {
  if (static_cast<int>(blockIdx.x) >= term_blocks) {
    // kFillVecs 16-byte stores a thread, one pass (a grid-stride loop
    // reached 3.15 TB/s on the H100, this 3.25)
    const int64_t fb = blockIdx.x - term_blocks, n4 = len / 4;
    float4* d4 = reinterpret_cast<float4*>(dtable);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kFillVecs; ++u) {
      const int64_t i = (fb * kFillVecs + u) * blockDim.x + threadIdx.x;
      if (i < n4) d4[i] = z;
    }
    if (fb == 0) {
      for (int64_t i = n4 * 4 + threadIdx.x; i < len; i += blockDim.x)
        dtable[i] = 0.0f;
      if (threadIdx.x < 4) sc.ctr[threadIdx.x] = 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
  if (gw >= static_cast<int64_t>(rows) * ktop) return;   // whole warp
  const int r = static_cast<int>(gw / ktop);
  const int j = static_cast<int>(gw - static_cast<int64_t>(r) * ktop);
  const bool node_form = tk_cols == nullptr;
  const int64_t e0 = gw * P;   // the slot's first entry

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
  if (!any) {                                            // whole warp
    for (int p = lane; p < P; p += 32) sc.key[e0 + p] = -1;
    return;
  }

  const int64_t node =
      node_form ? r : tk_cols[static_cast<int64_t>(r) * ktop + j];
  const int32_t* ac = attr_cols + node * P;
  const float* av = attr_vals + node * P;
  const float s = attr_mass(av, P, lane) + 1e-10f;
  for (int p = lane; p < P; p += 32) {
    const int32_t c = ac[p];
    const float a = av[p];
    const bool adds = a != 0.0f && c >= vocab_lo && c < vocab_hi;
    sc.key[e0 + p] = adds ? c - vocab_lo : -1;
    sc.val[e0 + p] = a;
  }

  float* sv = sc.sv + gw * (DROP ? K : 1) * H;
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
    if constexpr (!DROP) {
      float tot[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        tot[0] += gn[k][0];
        tot[1] += gn[k][1];
      }
      if (ha < H) sv[ha] = tot[0];
      if (hb < H) sv[hb] = tot[1];
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (ha < H) sv[k * H + ha] = gn[k][0] / keep_prob;
        if (hb < H) sv[k * H + hb] = gn[k][1] / keep_prob;
      }
    }
  }
}

// Launch 2, a thread an entry: each live entry's rank among its id's entries
// (the lanes of a warp holding one id take theirs with one atomicAdd on the
// id's word), its entry and value into its id's row if its rank is below
// cap; the ids' first entries append the ids to the leader list, one
// atomicAdd a block. The ranks follow the atomics' timing; the order of the
// adds does not.
__global__ void __launch_bounds__(kThreads) embed_prop_bwd_count_kernel(
    float* __restrict__ dtable, BwdScratch sc, int64_t num_entries, int H) {
  __shared__ int warp_at[kThreads / 32];
  __shared__ int block_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int cl = e < num_entries ? sc.key[e] : -1;
  const unsigned peers = __match_any_sync(kFull, cl);
  int rk = -1;
  if (cl >= 0) {
    const int first = __ffs(peers) - 1;
    int at = 0;
    if (lane == first) at = atomicAdd(id_word(dtable, cl, H), __popc(peers));
    at = __shfl_sync(peers, at, first);
    rk = at + __popc(peers & ((1u << lane) - 1u));
    if (rk < row_cap(H)) {
      int* w = id_word(dtable, cl, H) + 1 + 2 * rk;
      w[0] = static_cast<int>(e);
      w[1] = __float_as_int(sc.val[e]);
    }
  }
  const unsigned m = __ballot_sync(kFull, rk == 0);
  if (lane == 0) warp_at[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = warp_at[w];
      warp_at[w] = total;
      total += c;
    }
    block_at = total > 0 ? atomicAdd(&sc.ctr[0], total) : 0;
  }
  __syncthreads();
  if (rk == 0)
    sc.lead[block_at + warp_at[warp] + __popc(m & ((1u << lane) - 1u))] = cl;
}

// Entry (slot, p)'s term at feature h, as the earlier backward stored it in
// its scratch row: the slot's vector times the attribute value a (with input
// dropout the kept augmentations' shares added first, in k order from
// 0.0f); each operation rounded on its own, so that none is contracted into
// an FMA with the sum it feeds.
template <int K, bool DROP>
__device__ __forceinline__ float entry_term(const float* __restrict__ sv,
                                            const uint8_t* __restrict__ drop,
                                            int64_t S, int slot, int p,
                                            float a, int P, int H, int h) {
  if constexpr (!DROP) {
    return __fmul_rn(sv[static_cast<int64_t>(slot) * H + h], a);
  } else {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t ks = k * S + slot;      // (k * rows + r) * ktop + j
      if (drop[(ks * P + p) * H + h] != 0)
        v = __fadd_rn(v, sv[(static_cast<int64_t>(slot) * K + k) * H + h]);
    }
    return __fmul_rn(v, a);
  }
}

// Launch 3, a warp an id present (grid-strided): an id with up to cap
// entries is summed here from its row: lane t reads the entry of rank t,
// its rank among the lanes' entries is its place in entry order, and the
// terms are added from 0.0f in that order, two features a lane, into the
// row. A longer id goes to the long list.
template <int K, bool DROP>
__global__ void __launch_bounds__(kThreads) embed_prop_bwd_sum_kernel(
    const uint8_t* __restrict__ drop, float* __restrict__ dtable,
    BwdScratch sc, int64_t S, int P, int H) {
  const int lane = threadIdx.x & 31;
  const int cap = row_cap(H);
  const int nlead = sc.ctr[0];
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       i < nlead; i += warps) {
    const int cl = sc.lead[i];
    float* row = dtable + static_cast<int64_t>(cl) * H;
    int* word = reinterpret_cast<int*>(row);
    int e = INT32_MAX;
    float a = 0.0f;
    if (lane < cap) {                 // read with the count, not after it
      e = word[1 + 2 * lane];
      a = row[2 + 2 * lane];
    }
    const int n = word[0];
    if (n > cap) {                                       // whole warp
      if (lane == 0) sc.longs[atomicAdd(&sc.ctr[1], 1)] = cl;
      continue;
    }
    if (lane >= n) e = INT32_MAX;
    int order = 0;
    for (int t = 0; t < n; ++t) order += __shfl_sync(kFull, e, t) < e;
    int slot = 0, p = 0;
    if (lane < n) {
      slot = e / P;
      p = e - slot * P;
    }
    __syncwarp();                      // the row is read before it is written
    for (int h0 = 0; h0 < H; h0 += kChunk) {
      const int ha = h0 + lane, hb = h0 + 32 + lane;
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int t = 0; t < n; ++t) {
        const int src = __ffs(__ballot_sync(kFull, lane < n && order == t)) - 1;
        const int st = __shfl_sync(kFull, slot, src);
        const int pt = __shfl_sync(kFull, p, src);
        const float at = __shfl_sync(kFull, a, src);
        if (ha < H)
          acc0 = __fadd_rn(acc0, entry_term<K, DROP>(sc.sv, drop, S, st, pt,
                                                     at, P, H, ha));
        if (hb < H)
          acc1 = __fadd_rn(acc1, entry_term<K, DROP>(sc.sv, drop, S, st, pt,
                                                     at, P, H, hb));
      }
      if (ha < H) row[ha] = acc0;
      if (hb < H) row[hb] = acc1;
    }
  }
}

// The exclusive prefix of v over the block's threads, in thread order, and
// the block's total; wtot holds a value a warp. Every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wtot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? wtot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nwarps) wtot[lane] = t;
  }
  __syncthreads();
  *total = wtot[nwarps - 1];
  const int before = warp > 0 ? wtot[warp - 1] : 0;
  __syncthreads();                       // wtot is written by the next call
  return before + incl - v;
}

// One tile of a long id's terms, [kTile entries, 64 features from h0], by
// the whole block from the listed entries' slots, attribute slots and
// values: thread t takes feature t % 64 of entries t / 64, t / 64 + bd / 64,
// ...; every load of the tile is issued before any term is formed
// (read-only loads, so none waits on the tile's stores).
template <int K, bool DROP>
__device__ __forceinline__ void long_tile(const uint8_t* __restrict__ drop,
                                          const BwdScratch& sc, int64_t S,
                                          int P, int H, int h0,
                                          const int* l_slot, const int* l_p,
                                          const float* l_a, int tn,
                                          float* tile) {
  constexpr int kItems = kTile * 64 / kThreads;
  const int c = threadIdx.x & 63, m0 = threadIdx.x >> 6;
  const int h = h0 + c;
  int slot[kItems];
  float v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int m = m0 + u * (kThreads / 64);
    slot[u] = m < tn && h < H ? l_slot[m] : -1;
    if constexpr (!DROP)
      v[u] = slot[u] < 0
                 ? 0.0f
                 : __ldg(sc.sv + static_cast<int64_t>(slot[u]) * H + h);
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (slot[u] < 0) continue;
    const int m = m0 + u * (kThreads / 64);
    if constexpr (DROP)
      tile[m * 64 + c] =
          entry_term<K, DROP>(sc.sv, drop, S, slot[u], l_p[m], l_a[m], P, H, h);
    else
      tile[m * 64 + c] = __fmul_rn(v[u], l_a[m]);
  }
}

// acc + col[0] + col[64] + ... over n terms, in that order, each add
// rounded on its own; the shared-memory reads of 8 terms are issued before
// their adds.
__device__ __forceinline__ float add_in_order(float acc, const float* col,
                                              int n) {
  int m = 0;
  for (; m + 8 <= n; m += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = col[(m + u) * 64];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, t[u]);
  }
  for (; m < n; ++m) acc = __fadd_rn(acc, col[m * 64]);
  return acc;
}

// kPerThread entry ids from e0 (-1 past the end), 16-byte loads where whole.
template <int N>
__device__ __forceinline__ void load_keys(const int* __restrict__ key,
                                          int64_t e0, int64_t E, int (&k)[N]) {
  if (e0 + N <= E) {                     // key is 16-byte aligned, e0 too
    const int4* k4 = reinterpret_cast<const int4*>(key + e0);
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const int4 q = __ldg(k4 + v);
      k[4 * v] = q.x;
      k[4 * v + 1] = q.y;
      k[4 * v + 2] = q.z;
      k[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) k[u] = e0 + u < E ? __ldg(key + e0 + u) : -1;
  }
}

// Launch 4, a block a long id (grid-strided): the block reads the entries'
// ids in entry order, kRound at a time (kPerThread consecutive ones a
// thread; the next round's loads issued before this round's matches are
// listed), lists the id's entries in that order with each one's slot,
// attribute slot and value (each thread's matches at its prefix of the
// round's counts), and whenever the list could not take another round,
// forms each tile of kTile entries' terms in shared memory (long_tile) and
// adds them in order, one thread a feature, 64 features at a time, the
// sums kept in registers.
template <int K, bool DROP>
__global__ void __launch_bounds__(kThreads) embed_prop_bwd_long_kernel(
    const uint8_t* __restrict__ drop, float* __restrict__ dtable,
    BwdScratch sc, int64_t S, int P, int H) {
  constexpr int kPerThread = 8, kRound = kThreads * kPerThread;
  constexpr int kList = 2560;
  __shared__ int l_slot[kList];
  __shared__ float l_a[kList];
  __shared__ int l_p[DROP ? kList : 1];
  __shared__ float tile[kTile * 64];
  __shared__ int wtot[32];
  const int tid = threadIdx.x;
  const int nlong = sc.ctr[1];
  const int64_t E = S * P;
  for (int q = blockIdx.x; q < nlong; q += gridDim.x) {
    const int cl = sc.longs[q];
    for (int h0 = 0; h0 < H; h0 += 64) {
      const bool adder = tid < 64 && h0 + tid < H;
      float acc = 0.0f;
      int listed = 0;                                    // the same in every thread
      int keys[kPerThread];
      load_keys(sc.key, static_cast<int64_t>(tid) * kPerThread, E, keys);
      for (int64_t b0 = 0; b0 < E; b0 += kRound) {
        const int64_t e0 = b0 + static_cast<int64_t>(tid) * kPerThread;
        unsigned mine = 0u;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u)
          mine |= static_cast<unsigned>(keys[u] == cl) << u;
        if (b0 + kRound < E) load_keys(sc.key, e0 + kRound, E, keys);
        int total;
        int at = listed + block_exclusive_scan(__popc(mine), wtot, &total);
        if (mine != 0u) {
          const int slot0 = static_cast<int>(e0 / P);
          const int p0 = static_cast<int>(e0 - static_cast<int64_t>(slot0) * P);
          while (mine != 0u) {
            const int u = __ffs(mine) - 1;
            mine &= mine - 1u;
            int slot = slot0, p = p0 + u;
            while (p >= P) {
              p -= P;
              ++slot;
            }
            l_slot[at] = slot;
            l_a[at] = __ldg(sc.val + e0 + u);
            if constexpr (DROP) l_p[at] = p;
            ++at;
          }
        }
        listed += total;
        if (listed > kList - kRound || b0 + kRound >= E) {   // whole block
          __syncthreads();
          for (int t0 = 0; t0 < listed; t0 += kTile) {
            const int tn = listed - t0 < kTile ? listed - t0 : kTile;
            long_tile<K, DROP>(drop, sc, S, P, H, h0, l_slot + t0,
                               DROP ? l_p + t0 : l_p, l_a + t0, tn, tile);
            __syncthreads();
            if (adder) acc = add_in_order(acc, tile + tid, tn);
            __syncthreads();
          }
          listed = 0;
        }
      }
      if (adder) dtable[static_cast<int64_t>(cl) * H + h0 + tid] = acc;
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
                       const uint8_t* drop, float* dtable, void* scratch,
                       int rows, int ktop, int P, int H, float keep_prob,
                       int vocab_lo, int vocab_hi, cudaStream_t stream) {
  const int64_t S = static_cast<int64_t>(rows) * ktop, E = S * P;
  const int64_t len = static_cast<int64_t>(vocab_hi - vocab_lo) * H;
  const BwdScratch sc = carve_scratch(scratch, rows, ktop, P, H,
                                      DROP ? K : 1);
  const int term_blocks =
      static_cast<int>((S + kThreads / 32 - 1) / (kThreads / 32));
  int64_t fill_blocks = (len / 4 + kThreads * kFillVecs - 1) /
                        (kThreads * kFillVecs);
  if (fill_blocks < 1) fill_blocks = 1;
  embed_prop_bwd_terms_kernel<K, DROP>
      <<<static_cast<unsigned>(term_blocks + fill_blocks), kThreads, 0,
         stream>>>(grad, attr_cols, attr_vals, tk_cols, tk_vals, keep, dtable,
                   len, sc, term_blocks, rows, ktop, P, H, keep_prob,
                   vocab_lo, vocab_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || E == 0) return err;
  const unsigned eb = static_cast<unsigned>((E + kThreads - 1) / kThreads);
  embed_prop_bwd_count_kernel<<<eb, kThreads, 0, stream>>>(dtable, sc, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t sb = (E + kThreads / 32 - 1) / (kThreads / 32);
  embed_prop_bwd_sum_kernel<K, DROP>
      <<<static_cast<unsigned>(sb < kMaxSumBlocks ? sb : kMaxSumBlocks),
         kThreads, 0, stream>>>(drop, dtable, sc, S, P, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t lb = E / (row_cap(H) + 1);
  embed_prop_bwd_long_kernel<K, DROP>
      <<<static_cast<unsigned>(lb < 1 ? 1
                               : lb < kMaxLongBlocks ? lb : kMaxLongBlocks),
         kThreads, 0, stream>>>(drop, dtable, sc, S, P, H);
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

// Both return the cudaError_t of their launches (0 on success). num_aug is
// K, 1..8. tk_cols == nullptr selects the node form (ktop must be 1, tk_vals
// and keep null); keep == nullptr keeps every slot; drop == nullptr applies
// no input dropout (keep_prob is then unused). table (and dtable) hold the
// rows [vocab_lo, vocab_hi) of the vocabulary; 0 and V for the whole
// table. embed_prop_bwd_f32 writes every element of dtable (16-byte
// aligned), taking scratch of embed_prop_bwd_scratch's bytes; rows x ktop x
// P must be below 2^31.
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
                                  float* dtable, void* scratch, int rows,
                                  int ktop, int P, int H, int num_aug,
                                  float keep_prob, int vocab_lo, int vocab_hi,
                                  void* stream) {
  if (vocab_hi <= vocab_lo || H == 0) return 0;
  if (static_cast<int64_t>(rows) * ktop * P >= INT32_MAX ||
      reinterpret_cast<uintptr_t>(dtable) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EMBED_PROP_DISPATCH(launch_bwd, grad, attr_cols, attr_vals, tk_cols,
                      tk_vals, keep, drop, dtable, scratch, rows, ktop, P, H,
                      keep_prob, vocab_lo, vocab_hi, s)
}

// out[0]: the bytes of embed_prop_bwd_f32's scratch at these shapes (drop:
// whether input dropout is on). nn/sparse_input.py's bwd_scratch_bytes
// mirrors it.
extern "C" int embed_prop_bwd_scratch(int rows, int ktop, int P, int H,
                                      int num_aug, int drop, int64_t* out) {
  out[0] = 4 * bwd_scratch_words(rows, ktop, P, H, drop ? num_aug : 1);
  return 0;
}
