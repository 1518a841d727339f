// K2-seg: one hop of the power iteration over A as padded, row-sorted COO
// (rows, cols, vals), the low-memory 'segment' backend, with the update
// fused into its epilogue:
//
//   h = sum_e x[col_e] * v_e       f32, each row's terms in edge order
//   y = scale * (h * row_scale[r]) acc += y   (row_scale optional)
//
// Replaces the TPU program grandtpu/sparse/spmm.py::spmm_segment (a
// lax.scan over edge chunks: gather x[cols] * vals, scatter-add into an
// [n + 1, F] accumulator whose last row swallows the padding) and the
// update around it, as driven by grandtpu/infer/propagate.py::
// _propagate_device with backend='segment' (y = scale * h, acc += y) and
// per shard by grandtpu/dist/spmm_shard.py::_sharded_prop (y = (h *
// dinv[r]) * scale, two roundings, acc += y). It reads only rows, cols and
// vals: no indptr, since low memory is the backend's reason to exist. With
// scale 1, no row scale and no accumulate it is the bare product A @ x.
//
// What bounds it on an H100: bytes. It must read the 12 bytes of each
// padded edge, x once, acc once, and write y and acc once: at the Amazon2M
// stand-in (nnz 8.9M, [2M, 100]) about 3.31 GB; its 2*nnz*F flops are far
// below the f32 rate. The gathers read nnz rows of x, not n.
//
// The design: one launch a hop, every output row written exactly once, no
// zero-fill, no atomics on y, no discard row.
// - Runs: the padded edges are cut into runs of kRun consecutive edges,
//   one a group of G lanes (a power of two up to 32) over the features
//   (NPER vectors of V neighbouring floats a lane, as K2's lane groups in
//   csr_spmm.cu). A row is owned by the group whose run holds its first
//   edge; that group walks it to its end in edge order, past its run if
//   the row goes on. A group skips the edges of a row that began before
//   its run. The owner also writes the rows with no edge between the
//   previous edge's row and its own (h = 0), and the owner of the last
//   real edge's row writes the rows after it (D1's padded rows), so the
//   padding edges (row = num_rows, at the end) are never read as terms.
// - Batched gathers: a row's edges are taken U at a time: their U + 1 row
//   ids (the extra one says whether the row goes on), U cols and U vals
//   are loaded at once, then the U * NPER vector gathers of x are issued
//   before any term is added; the terms of the batch's own edges are
//   added in edge order with __fadd_rn(s, __fmul_rn(x, v)), as grandtpu's
//   x[c] * v scatter-add rounds them. acc is read at the start of a row,
//   and y and acc are streamed (csr_hop.cuh's evict-first carries).
// - Hub rows: one group walking a 15,000-edge row would finish long after
//   the rest of the hop, so a row with more than `cap` edges is cut by the
//   operator's split plan (sparse/spmm.py::SplitPlan, built from the row
//   counts) into chunks of at most cap edges, with csr_hop.cuh's
//   Split/last_chunk protocol: the grid's first items are the chunks, each
//   writes its f32 sum to the caller's [chunks, F] scratch, and the group
//   that finishes a split row's last chunk (an integer counter a split
//   row) adds them in chunk order and applies the update. A run's owner
//   finds the next split row by one binary search over the plan's rows and
//   leaves it to its chunks (a split row, longer than cap >= kRun edges,
//   runs past the end of the run, so no other row starts after it there).
// Rows under the cap add in edge order from 0, so the hop is bit for bit
// its plain version (sparse/spmm.py::spmm_segment_prop_step_plain), which
// groups a split row's terms as the chunks do. Offsets into x and y are
// 64-bit: E * F passes 2^31 near the Amazon2M stand-in.
//
// bf16 carries (exact_propagate's bf16_carry): x, y and acc are bf16, the
// rest is the f32 form. grandtpu's segment hop on bf16 x computes each
// term x[c] * v in f32 (bf16 times the f32 edge value promotes), and its
// scatter-add promotes the bf16 accumulator to f32 too (jax's
// _scatter_impl: promote_dtypes, then one convert back): each row is an
// f32 sum of f32 terms in edge order, rounded to bf16 once, and the ppr
// update then runs in bf16 (csr_hop.cuh's bf16 store_update, with the
// scale rounded to bf16 by the caller). So the bf16 form gathers bf16
// rows, adds as the f32 form adds, and rounds h, y and acc to bf16; it
// moves half the carries' bytes. grandtpu also rounds at the boundaries
// of its scan's 2^18-edge chunks, which the port does not: a row that
// straddles one (at most one a chunk) may differ by about a bf16 ulp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_hop.cuh"

namespace {

using grandtpu::Split;

constexpr int kThreads = 256;
constexpr int kRun = 32;   // edges a run holds; the plan's cap is >= kRun

// T: the carries' type, float or __nv_bfloat16.
template <typename T>
struct SegArgs {
  const int32_t* rows;
  const int32_t* cols;
  const float* vals;
  const T* x;
  T* y;
  T* acc;                  // null when accumulate is 0
  const float* row_scale;  // null: none
  int64_t num_edges;
  int num_rows, num_features;
  float scale;
  int accumulate;
  Split split;
};

// The lanes and features of a group: lane g owns NPER vectors of V
// features of each tile of lanes * NPER * V, vector p at
// f_tile + (p * lanes + g) * V.
struct Lane {
  int g, lanes;
};

// y and acc of row r at features f..f+V from the row's sums s and acc's
// values a there (zero when not accumulating).
template <typename T, int V>
__device__ __forceinline__ void store_row(const SegArgs<T>& a, int64_t r,
                                          int f,
                                          const float (&s)[V],
                                          const float (&acc_v)[V]) {
  float h[V], stored[V];
  const float rs = a.row_scale != nullptr ? __ldg(a.row_scale + r) : 1.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    h[j] = a.row_scale != nullptr ? __fmul_rn(s[j], rs) : s[j];
  }
  grandtpu::store_update(h, acc_v, a.scale, a.y, a.acc,
                         r * a.num_features + f, a.accumulate, stored);
}

template <typename T, int V>
__device__ __forceinline__ void load_acc(const SegArgs<T>& a, int64_t r,
                                         int f, float (&acc_v)[V]) {
  if (a.accumulate) {
    grandtpu::load_carries(a.acc + r * a.num_features + f, acc_v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) acc_v[j] = 0.0f;
  }
}

// The rows r0..r1-1, which have no edge: h = 0, then the update.
template <typename T, int V, int NPER>
__device__ void empty_rows(const SegArgs<T>& a, Lane l, int64_t r0,
                           int64_t r1) {
  const int F = a.num_features;
  for (int64_t r = r0; r < r1; ++r) {
    for (int f_tile = 0; f_tile < F; f_tile += l.lanes * NPER * V) {
#pragma unroll
      for (int p = 0; p < NPER; ++p) {
        const int f = f_tile + (p * l.lanes + l.g) * V;
        if (f >= F) continue;
        float s[V], acc_v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] = 0.0f;
        load_acc(a, r, f, acc_v);
        store_row(a, r, f, s, acc_v);
      }
    }
  }
}

// Row r's edges from lo, at most up to limit: their sums in edge order,
// then, for a chunk (item >= 0), its sums before any scale into the
// partial scratch, else the update of row r. Returns the end of the edges
// walked (the row's end, or limit).
template <typename T, int V, int NPER, int U>
__device__ int64_t walk_row(const SegArgs<T>& a, Lane l, int r, int64_t lo,
                            int64_t limit, int64_t item) {
  const int F = a.num_features;
  const bool chunk = item >= 0;
  float* partial = static_cast<float*>(a.split.partial);
  int64_t hi = -1;   // the end, once the first tile found it
  for (int f_tile = 0; f_tile < F; f_tile += l.lanes * NPER * V) {
    float acc_v[NPER][V];
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
      const int f = f_tile + (p * l.lanes + l.g) * V;
      if (!chunk && f < F) {
        load_acc(a, r, f, acc_v[p]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) acc_v[p][j] = 0.0f;
      }
    }
    float s[NPER][V];
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
#pragma unroll
      for (int j = 0; j < V; ++j) s[p][j] = 0.0f;
    }
    const int64_t end = hi >= 0 ? hi : limit;
    int64_t e = lo;
    bool more = true;
    while (more) {
      // the batch's ids and values, all loads at once; then which of its
      // edges are row r's (a prefix) and whether the row goes on
      int rid[U + 1], c[U];
      float v[U];
#pragma unroll
      for (int u = 0; u <= U; ++u) {
        rid[u] = hi < 0 && e + u < end ? __ldg(a.rows + e + u) : r;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = e + u < end ? __ldg(a.cols + e + u) : 0;
        v[u] = e + u < end ? __ldg(a.vals + e + u) : 0.0f;
      }
      int count = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        count += (count == u && e + u < end && rid[u] == r) ? 1 : 0;
      }
      more = count == U && e + U < end && rid[U] == r;
      float xv[U][NPER][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
          const int f = f_tile + (p * l.lanes + l.g) * V;
          if (u < count && f < F) {
            grandtpu::load_x(a.x + static_cast<int64_t>(c[u]) * F + f,
                             xv[u][p]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) xv[u][p][j] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= count) break;
#pragma unroll
        for (int p = 0; p < NPER; ++p) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s[p][j] = __fadd_rn(s[p][j], __fmul_rn(xv[u][p][j], v[u]));
          }
        }
      }
      e += count;
    }
    hi = e;
#pragma unroll
    for (int p = 0; p < NPER; ++p) {
      const int f = f_tile + (p * l.lanes + l.g) * V;
      if (f >= F) continue;
      if (chunk) {
#pragma unroll
        for (int j = 0; j < V; ++j) partial[item * F + f + j] = s[p][j];
      } else {
        store_row(a, r, f, s[p], acc_v[p]);
      }
    }
  }
  return hi;
}

// Whether edge e is past the last real edge: the end, or the padding.
template <typename T>
__device__ __forceinline__ bool past_real(const SegArgs<T>& a, int64_t e) {
  return e >= a.num_edges || __ldg(a.rows + e) >= a.num_rows;
}

// The smallest split row >= r (INT_MAX: none).
__device__ int next_split_row(const Split& s, int r) {
  if (s.num_chunks == 0) return 0x7fffffff;
  int lo = 0, hi = s.chunk_row[s.num_chunks - 1] + 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(s.rows + mid) < r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo <= s.chunk_row[s.num_chunks - 1] ? __ldg(s.rows + lo)
                                             : 0x7fffffff;
}

template <typename T, int V, int NPER, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
coo_spmm_kernel(SegArgs<T> a, int lanes, int log_lanes) {
  const Lane l{static_cast<int>(threadIdx.x & (lanes - 1)), lanes};
  const int64_t item =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
      log_lanes;
  const Split& sp = a.split;
  const int n = a.num_rows;
  const int64_t E = a.num_edges;
  if (item < sp.num_chunks) {
    const int r = sp.rows[sp.chunk_row[item]];
    const int64_t lo = sp.chunk_lo[item];
    const int64_t limit = lo + sp.cap < E ? lo + sp.cap : E;
    const int64_t end = walk_row<T, V, NPER, U>(a, l, r, lo, limit, item);
    // the chunk that ends the last real row writes the rows after it
    if (past_real(a, end)) empty_rows<T, V, NPER>(a, l, r + 1, n);
    if (!grandtpu::last_chunk(sp, item, lanes)) return;
    // the group that finished the row's last chunk adds the row's partials
    // in chunk order, then applies the update
    const int i = sp.chunk_row[item];
    const int c0 = sp.chunk_ptr[i];
    const int c1 = sp.chunk_ptr[i + 1];
    const float* partial = static_cast<const float*>(sp.partial);
    for (int f = l.g; f < a.num_features; f += lanes) {
      float s[1] = {0.0f}, acc_v[1];
      for (int c = c0; c < c1; ++c) {
        s[0] = __fadd_rn(
            s[0], __ldcg(partial + static_cast<int64_t>(c) * a.num_features
                         + f));
      }
      load_acc(a, r, f, acc_v);
      store_row(a, r, f, s, acc_v);
    }
    return;
  }
  const int64_t e0 = (item - sp.num_chunks) * kRun;
  if (e0 == 0 && past_real(a, 0)) {
    empty_rows<T, V, NPER>(a, l, 0, n);   // no real edge at all
    return;
  }
  if (e0 >= E) return;
  const int64_t e_end = e0 + kRun < E ? e0 + kRun : E;
  int prev = e0 > 0 ? __ldg(a.rows + e0 - 1) : -1;
  if (prev >= n) return;               // the padding only
  int64_t e = e0;
  while (e < e_end && __ldg(a.rows + e) == prev) ++e;   // begun before
  const int split_row =
      e < e_end ? next_split_row(sp, __ldg(a.rows + e)) : 0x7fffffff;
  while (e < e_end) {
    const int r = __ldg(a.rows + e);
    if (r >= n) break;   // the padding: the last real row's owner is done
    empty_rows<T, V, NPER>(a, l, prev + 1, r);
    if (r == split_row) break;         // its chunks add it
    e = walk_row<T, V, NPER, U>(a, l, r, e, E, -1);
    if (past_real(a, e)) empty_rows<T, V, NPER>(a, l, r + 1, n);
    prev = r;
  }
}

// A launch configuration: V floats a vector, NPER vectors a lane, U edges
// gathered before their terms are added, MINB blocks of kThreads an SM.
struct Config {
  int v, nper, u, minb;
};

#define SEG_CONFIGS(X) X(4, 1, 4, 4) X(2, 2, 4, 4) X(1, 2, 4, 4)

// The widest vector (4, 2 or 1 carries) that F and the alignment of x, y
// and acc allow, and that width's configuration.
Config pick_config(int num_features, int carry_bytes, const void* x,
                   const void* y, const void* acc) {
  for (int v = 4; v > 1; v /= 2) {
    const unsigned int bytes = carry_bytes * v;
    if (num_features % v == 0 && grandtpu::aligned(x, bytes) &&
        grandtpu::aligned(y, bytes) &&
        (acc == nullptr || grandtpu::aligned(acc, bytes))) {
      return v == 4 ? Config{4, 1, 4, 4} : Config{2, 2, 4, 4};
    }
  }
  return Config{1, 2, 4, 4};
}

template <typename T, int V, int NPER, int U, int MINB>
int launch_kernel(const SegArgs<T>& a, int64_t items, int lanes,
                  cudaStream_t stream) {
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes) ++log_lanes;
  const int64_t blocks = (items * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  coo_spmm_kernel<T, V, NPER, U, MINB>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          a, lanes, log_lanes);
  return static_cast<int>(cudaGetLastError());
}

// The launch for carries of type T (the pointers' type as the caller gives
// them, float or __nv_bfloat16).
template <typename T>
int launch(const int32_t* rows, const int32_t* cols, const float* vals,
           const void* x, void* y, void* acc, const float* row_scale,
           int64_t num_edges, int num_rows, int num_features, float scale,
           int accumulate, const Split& split, cudaStream_t s) {
  const SegArgs<T> a{rows, cols, vals, static_cast<const T*>(x),
                     static_cast<T*>(y),
                     accumulate ? static_cast<T*>(acc) : nullptr, row_scale,
                     num_edges, num_rows, num_features, scale, accumulate,
                     split};
  const Config c = pick_config(num_features, sizeof(T), x, y, a.acc);
  const int vecs = (num_features + c.v - 1) / c.v;
  int lanes = 1;
  while (lanes < 32 && lanes * c.nper < vecs) lanes *= 2;
  // the chunks, then the runs (one at least: with no real edge, run 0
  // writes every row)
  const int64_t runs = num_edges > 0 ? (num_edges + kRun - 1) / kRun : 1;
  const int64_t items = split.num_chunks + runs;
#define SEG_PICK(V, N, U, M)                                         \
  if (c.v == V && c.nper == N && c.u == U && c.minb == M) {          \
    return launch_kernel<T, V, N, U, M>(a, items, lanes, s);         \
  }
  SEG_CONFIGS(SEG_PICK)
#undef SEG_PICK
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). rows, cols, vals
// [num_edges] (rows sorted, the padding rows = num_rows at the end, which
// the caller checks), x [num_cols, F], y [num_rows, F] (every row
// written), acc [num_rows, F] (may be null when accumulate is 0): f32, or
// all three bf16 with carry_bf16 (scale then already rounded to bf16);
// row_scale [num_rows] f32 or null. x must alias neither y nor acc. The
// split plan as csr_spmm_prop's (num_chunks = 0: none; cap >= 32, the
// run length): the split rows (ascending), each one's chunks
// chunk_ptr[i] : chunk_ptr[i + 1], each chunk's split-row index and first
// edge; partial is f32 [num_chunks, F] scratch and counters int32 [split
// rows], zero before the launch.
extern "C" int coo_spmm(const int32_t* rows, const int32_t* cols,
                        const float* vals, const void* x, void* y, void* acc,
                        const float* row_scale, int64_t num_edges,
                        int num_rows, int num_features, float scale,
                        int accumulate, int carry_bf16,
                        const int32_t* split_rows, const int32_t* chunk_ptr,
                        const int32_t* chunk_row, const int32_t* chunk_lo,
                        int num_chunks, int cap, float* partial,
                        int* counters, void* stream) {
  if (num_rows == 0 || num_features == 0) return 0;
  if (num_chunks > 0 && cap < kRun) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Split split{split_rows, chunk_ptr, chunk_row, chunk_lo, num_chunks,
                    num_chunks ? cap : 0x7fffffff, partial, counters};
  auto s = static_cast<cudaStream_t>(stream);
  return carry_bf16
      ? launch<__nv_bfloat16>(rows, cols, vals, x, y, acc, row_scale,
                              num_edges, num_rows, num_features, scale,
                              accumulate, split, s)
      : launch<float>(rows, cols, vals, x, y, acc, row_scale, num_edges,
                      num_rows, num_features, scale, accumulate, split, s);
}
