// The sparse-residue GFPush (P2): one hop's expansion and compaction.
//
// Replaces the TPU program grandtpu/ppr/bucket_push.py::gfpush_bucketed
// (:409) with its _hop (:141), _dedup_rows (:117) and _push_block (:329);
// the final selection is push_topk.cu (_finalize, :262). The math is
// grandtpu's (reference graph.h:53-131); the TPU layout (shape buckets,
// replay plans, w-wide edge blocks, sort-based dedup) is not carried over.
// For a block of B sources, each source b has a frontier of live residues
// (node u, value q) in its own region of flat arrays. Values are 62-bit
// fixed point in unsigned 64-bit integers (1.0 = 2^62; every residue and
// reserve is <= 1), so every sum is an integer atomicAdd, exact and the
// same in any order: a float atomicAdd would add in launch order, and one
// ulp can move an rmax decision, the next frontier and the top-k.
//
// bucket_expand, hop mode (one CTA a source, a thread an entry): an entry
// of a dangling node sends q back to the source; an entry with
// q >= thr[u] = ceil(rmax * deg(u) * 2^62) sends q / deg(u) (integer
// division) to each neighbour. Targets are summed in the source's
// open-addressing hash table (linear probing, atomicCAS on the key,
// atomicAdd on the value), whose capacity is twice the expansion slots the
// frontier needs (counted by the previous compaction; the host reads one
// sum a hop to size the tables). Merge mode adds an entry's reserve
// contribution trunc(coef * q) at its own node: run once per hop's frontier
// into one reserve table, it is the reserve log's dedup.
//
// bucket_compact, hop mode (one CTA a source): the table's live slots
// become the next frontier, in the table's region, with their count and the
// expansion slots of the next hop (deg(u) for a pushing entry, 1 for a
// dangling one). Slot order depends on the order of the inserts, but no
// result does: the sums are exact, and push_topk orders by (value, id).
// Final mode converts a reserve table's values to f32 for push_topk.
//
// What bounds them on an H100: bytes, and the latency of dependent loads.
// A hop must read the frontier (12 bytes an entry), each pushing entry's
// row bounds and threshold, its neighbour ids (4 bytes a slot), and write
// the next frontier (12 bytes an entry); the arithmetic is a few integer
// operations a slot. A thread walks one entry's neighbour list, so a hub
// row is right but serial on one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int32_t kEmpty = -1;

__device__ __forceinline__ void table_add(int32_t* keys, u64* vals,
                                          int64_t base, int64_t cap,
                                          int32_t key, u64 add) {
  int64_t h = static_cast<int64_t>(
      (static_cast<uint32_t>(key) * 2654435761u) % static_cast<uint64_t>(cap));
  // the caller sizes a table at twice its inserts, so a free slot is
  // always found; the bound only keeps a wrongly sized table from spinning
  for (int64_t probe = 0; probe < cap; ++probe) {
    const int32_t prev = atomicCAS(keys + base + h, kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicAdd(vals + base + h, add);
      return;
    }
    h = h + 1 == cap ? 0 : h + 1;
  }
}

__global__ void bucket_expand_kernel(
    const int32_t* __restrict__ f_ids, const u64* __restrict__ f_q,
    const int64_t* __restrict__ f_off, const int64_t* __restrict__ f_cnt,
    const int32_t* __restrict__ src, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const u64* __restrict__ thr,
    const int64_t* __restrict__ t_off, int32_t* __restrict__ keys,
    u64* __restrict__ vals, int merge, double coef) {
  const int b = blockIdx.x;
  const int64_t base = t_off[b];
  const int64_t cap = t_off[b + 1] - base;
  const int64_t f0 = f_off[b];
  const int64_t cnt = f_cnt[b];
  if (cap == 0) return;
  for (int64_t j = threadIdx.x; j < cnt; j += blockDim.x) {
    const int32_t u = f_ids[f0 + j];
    const u64 q = f_q[f0 + j];
    if (merge) {
      const u64 c = __double2ull_rz(__dmul_rn(coef, __ull2double_rn(q)));
      if (c != 0) table_add(keys, vals, base, cap, u, c);
      continue;
    }
    const int32_t lo = indptr[u];
    const int32_t hi = indptr[u + 1];
    if (lo == hi) {                      // dangling: teleport to the source
      table_add(keys, vals, base, cap, src[b], q);
      continue;
    }
    if (q < thr[u]) continue;            // pruned: drained, not pushed
    const u64 p = q / static_cast<u64>(hi - lo);
    if (p == 0) continue;
    for (int32_t e = lo; e < hi; ++e) {
      table_add(keys, vals, base, cap, __ldg(indices + e), p);
    }
  }
}

__global__ void bucket_compact_kernel(
    const int32_t* __restrict__ keys, const u64* __restrict__ vals,
    const int64_t* __restrict__ t_off, const int32_t* __restrict__ indptr,
    const u64* __restrict__ thr, int32_t* __restrict__ out_ids,
    u64* __restrict__ out_q, int64_t* __restrict__ out_cnt,
    int64_t* __restrict__ out_exp, float* __restrict__ out_f, int final) {
  __shared__ unsigned int s_cnt;
  __shared__ u64 s_exp;
  const int b = blockIdx.x;
  const int64_t base = t_off[b];
  const int64_t end = t_off[b + 1];
  if (final) {
    for (int64_t s = base + threadIdx.x; s < end; s += blockDim.x) {
      out_f[s] = keys[s] == kEmpty
                     ? 0.0f
                     : __double2float_rn(__ull2double_rn(vals[s]) * 0x1p-62);
    }
    return;
  }
  if (threadIdx.x == 0) {
    s_cnt = 0;
    s_exp = 0;
  }
  __syncthreads();
  for (int64_t s = base + threadIdx.x; s < end; s += blockDim.x) {
    const int32_t key = keys[s];
    if (key == kEmpty) continue;
    const u64 q = vals[s];
    const int64_t pos = base + atomicAdd(&s_cnt, 1u);
    out_ids[pos] = key;
    out_q[pos] = q;
    const int32_t d = indptr[key + 1] - indptr[key];
    const u64 slots = d == 0 ? 1ull : (q >= thr[key] ? static_cast<u64>(d) : 0ull);
    if (slots != 0) atomicAdd(&s_exp, slots);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out_cnt[b] = s_cnt;
    out_exp[b] = static_cast<int64_t>(s_exp);
  }
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success); the values
// (f_q, thr, vals, out_q) are Q62 unsigned 64-bit integers. The frontier of
// source b is f_ids/f_q[f_off[b] : f_off[b] + f_cnt[b]]; its table is
// keys/vals[t_off[b] : t_off[b + 1]], keys filled with -1 and vals with 0 by
// the caller.
extern "C" int bucket_expand(const int32_t* f_ids, const void* f_q,
                             const int64_t* f_off, const int64_t* f_cnt,
                             const int32_t* src, const int32_t* indptr,
                             const int32_t* indices, const void* thr,
                             const int64_t* t_off, int32_t* keys, void* vals,
                             int num_sources, int merge, double coef,
                             void* stream) {
  if (num_sources == 0) return 0;
  bucket_expand_kernel<<<num_sources, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f_ids, static_cast<const u64*>(f_q), f_off, f_cnt, src, indptr, indices,
      static_cast<const u64*>(thr), t_off, keys, static_cast<u64*>(vals),
      merge, coef);
  return static_cast<int>(cudaGetLastError());
}

// Hop mode writes the next frontier into out_ids/out_q at the table's
// offsets, with out_cnt and out_exp [num_sources]; final mode writes out_f,
// the table's values as f32 (0 at empty slots).
extern "C" int bucket_compact(const int32_t* keys, const void* vals,
                              const int64_t* t_off, const int32_t* indptr,
                              const void* thr, int32_t* out_ids, void* out_q,
                              int64_t* out_cnt, int64_t* out_exp,
                              float* out_f, int num_sources, int final,
                              void* stream) {
  if (num_sources == 0) return 0;
  bucket_compact_kernel<<<num_sources, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<const u64*>(vals), t_off, indptr,
      static_cast<const u64*>(thr), out_ids, static_cast<u64*>(out_q),
      out_cnt, out_exp, out_f, final);
  return static_cast<int>(cudaGetLastError());
}
