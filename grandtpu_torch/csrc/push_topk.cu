// Per-row top-k of the GFPush device backends.
//
// Replaces the final selection of both TPU pushes: lax.top_k over the dense
// reserve rows in grandtpu/ppr/jax_push.py::_push_block (:69, P1), and
// grandtpu/ppr/bucket_push.py::_finalize (:262, P2), which dedups the reserve
// log and takes lax.top_k of each id-sorted row. For each row r, whose
// entries are vals[row_off[r] : row_off[r + 1]] with ids from `ids` (or
// their positions in the row when `ids` is null), it writes the k largest
// values that are > 0, sorted by value descending and, between equal values,
// by id ascending (the oracle's stable argsort; lax.top_k's order over an
// id-sorted row), padded with col 0 and val 0.
//
// Each positive entry gets a 64-bit key: the value's float bits (which order
// positive floats) above, ~id below. Keys are unique within a row (ids are),
// and a larger key is a larger value or, at equal values, a smaller id, so
// the result is fixed by the row's keys whatever order they are found in.
//
// What bounds it on an H100: bytes. It must read every entry of a row once
// (vals, and the ids of the positive ones) and write k entries: P1's 512
// rows of 233,000 f32 at the reddit stand-in are 477 MB, 0.14 ms at
// 3.35 TB/s. The design reads each row from device memory once:
// - One CTA (512 threads) a row streams it with 16-byte loads, four in
//   flight a thread, and keeps only the positive entries, as keys, in a
//   candidate buffer in dynamic shared memory (12,288 keys, 96 KB; two
//   CTAs fit an SM). A warp appends its keys at slots it reserves with one
//   shared atomic (a shuffle scan of the lanes' counts), not one atomic a
//   key. The pass also reduces the min and max key.
// - If at most k keys were found, all are kept. Otherwise a radix select
//   over the buffer finds the k-th largest key, 8 bits a pass, starting
//   just below the bits that the min and max keys share (so no pass spends
//   itself on digits every candidate has, which for values in (1e-7, 1]
//   piled every key into 2-3 bins of the top byte). Each warp counts into a
//   histogram of its own; 256 threads merge them and find the bin by a
//   parallel scan. It stops when the chosen bin holds exactly the keys
//   still wanted.
// - The at most k selected keys are gathered and sorted by a bitonic sort
//   in shared memory, and written out.
// - A row with more positive entries than the buffer holds (the
//   candidates past it are counted, not kept) is selected by the same
//   radix passes reading the row from device memory instead; the result is
//   the same, only slower. The wrapper allocates nothing for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kCap = 12288;                 // candidate keys in shared memory
constexpr int kUnroll = 4;                  // 16-byte loads in flight a thread
// candidates, then the warps' histograms (the selected keys reuse them)
constexpr size_t kSmemBytes = kCap * 8 + kWarps * 256 * 4;
static_assert(kWarps * 256 * 4 >= kMaxK * 8, "sel must fit the histograms");

__device__ __forceinline__ unsigned long long topk_key(float v, int32_t id) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned long long>(~static_cast<unsigned int>(id));
}

struct RowCtl {
  unsigned long long prefix, mask;
  unsigned int need, count, sel_count;
  int done;
  unsigned int warp_sum[kWarps];
  unsigned long long wmin[kWarps], wmax[kWarps];
};

// Appends this thread's positive entries among v[0, nvalid) (row positions
// j0 .. j0 + nvalid - 1) to the candidates. Every lane of the warp calls it.
__device__ __forceinline__ void append(const float (&v)[4], int nvalid,
                                       int64_t j0, const int32_t* ids,
                                       int64_t start, unsigned long long* cand,
                                       RowCtl& ctl, unsigned long long& kmin,
                                       unsigned long long& kmax) {
  const int lane = threadIdx.x & 31;
  unsigned long long keys[4];
  bool pos_[4];
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos_[i] = i < nvalid && v[i] > 0.0f;
    keys[i] = 0ull;
    if (pos_[i]) {
      const int64_t j = j0 + i;
      keys[i] = topk_key(v[i], ids ? __ldg(ids + start + j)
                                   : static_cast<int32_t>(j));
      kmin = min(kmin, keys[i]);
      kmax = max(kmax, keys[i]);
      ++n;
    }
  }
  // the lanes' exclusive offsets and the warp's total, by shuffles
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total == 0) return;
  unsigned int base = 0;
  if (lane == 31) base = atomicAdd(&ctl.count, static_cast<unsigned>(total));
  base = __shfl_sync(0xffffffffu, base, 31);
  unsigned int p = base + incl - n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pos_[i]) {
      if (p < kCap) cand[p] = keys[i];
      ++p;
    }
  }
}

// Calls f(key) for every candidate key of the row: from shared memory, or
// (kFromRow) from the row in device memory.
template <bool kFromRow, typename Fn>
__device__ __forceinline__ void for_each_key(const unsigned long long* cand,
                                             unsigned int count,
                                             const int32_t* ids,
                                             const float* vals, int64_t start,
                                             int64_t len, Fn f) {
  if (kFromRow) {
    for (int64_t j = threadIdx.x; j < len; j += kThreads) {
      const float v = __ldg(vals + start + j);
      if (v > 0.0f) {
        f(topk_key(v, ids ? __ldg(ids + start + j)
                          : static_cast<int32_t>(j)));
      }
    }
  } else {
    for (unsigned int i = threadIdx.x; i < count; i += kThreads) f(cand[i]);
  }
}

// Radix select of the k-th largest key: leaves in ctl the prefix and mask
// of the keys to keep (those whose masked bits are >= prefix).
template <bool kFromRow>
__device__ void radix_select(const unsigned long long* cand,
                             unsigned int* whist, const int32_t* ids,
                             const float* vals, int64_t start, int64_t len,
                             int k, unsigned long long kmin,
                             unsigned long long kmax, RowCtl& ctl) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // kmin != kmax: more than k >= 1 unique keys
  const int top = 63 - __clzll(static_cast<long long>(kmin ^ kmax));
  const unsigned long long common = top == 63 ? 0ull : ~0ull << (top + 1);
  unsigned long long prefix = kmin & common;
  unsigned long long mask = common;
  unsigned int need = k;
  unsigned int* hist = whist + warp * 256;
  for (int shift = max(top - 7, 0);; shift = max(shift - 8, 0)) {
    for (int i = tid; i < kWarps * 256; i += kThreads) whist[i] = 0;
    __syncthreads();
    for_each_key<kFromRow>(
        cand, ctl.count, ids, vals, start, len,
        [&](unsigned long long key) {
          if ((key & mask) == prefix) {
            atomicAdd(&hist[static_cast<unsigned int>(key >> shift) & 255u],
                      1u);
          }
        });
    __syncthreads();
    // bins from the top: thread t holds bin 255 - t; an inclusive scan
    // gives the count of keys in that bin and above
    unsigned int c = 0, incl = 0;
    if (tid < 256) {
      const int b = 255 - tid;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += whist[w * 256 + b];
      incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) ctl.warp_sum[warp] = incl;
    }
    __syncthreads();
    if (tid < 256) {
      for (int w = 0; w < warp; ++w) incl += ctl.warp_sum[w];
      const unsigned int above = incl - c;
      if (above < need && need <= incl) {    // exactly one thread
        const unsigned long long b = 255 - tid;
        ctl.prefix = prefix | (b << shift);
        ctl.mask = mask | (255ull << shift);
        ctl.need = need - above;
        ctl.done = c == need - above;
      }
    }
    __syncthreads();
    prefix = ctl.prefix;
    mask = ctl.mask;
    need = ctl.need;
    // with every bit fixed the bin is one key, so done holds by shift 0
    if (ctl.done || shift == 0) break;
    __syncthreads();     // every thread has read ctl before it is rewritten
  }
}

__global__ void __launch_bounds__(kThreads)
push_topk_kernel(const int32_t* __restrict__ ids,
                 const float* __restrict__ vals,
                 const int64_t* __restrict__ row_off, int k,
                 int32_t* __restrict__ out_cols,
                 float* __restrict__ out_vals) {
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned long long* cand = smem;
  unsigned int* whist = reinterpret_cast<unsigned int*>(smem + kCap);
  unsigned long long* sel = smem + kCap;     // after the select
  __shared__ RowCtl ctl;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t start = row_off[row];
  const int64_t len = row_off[row + 1] - start;
  if (tid == 0) {
    ctl.count = 0;
    ctl.sel_count = 0;
    ctl.prefix = 0;
    ctl.mask = 0;
    ctl.done = 0;
  }
  __syncthreads();

  // 1. one streaming pass: scalar head up to a 16-byte boundary, float4
  // body, scalar tail (the head and tail have fewer than 4 entries each)
  unsigned long long kmin = ~0ull, kmax = 0ull;
  const float* v_row = vals + start;
  const int64_t head = min(
      len, static_cast<int64_t>(
               ((16 - (reinterpret_cast<uintptr_t>(v_row) & 15)) & 15) >> 2));
  const int64_t nvec = (len - head) >> 2;
  const int64_t tail0 = head + nvec * 4;
  {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tid < head) v[0] = __ldg(v_row + tid);
    append(v, tid < head ? 1 : 0, tid, ids, start, cand, ctl, kmin, kmax);
  }
  const float4* body = reinterpret_cast<const float4*>(v_row + head);
  for (int64_t base = 0; base < nvec; base += kThreads * kUnroll) {
    float4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + tid;
      w[u] = i < nvec ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + tid;
      const float v[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      append(v, i < nvec ? 4 : 0, head + i * 4, ids, start, cand, ctl, kmin,
             kmax);
    }
  }
  {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool mine = tail0 + tid < len;
    if (mine) v[0] = __ldg(v_row + tail0 + tid);
    append(v, mine ? 1 : 0, tail0 + tid, ids, start, cand, ctl, kmin, kmax);
  }
  // the row's min and max key
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  }
  if (lane == 0) {
    ctl.wmin[warp] = kmin;
    ctl.wmax[warp] = kmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    kmin = min(kmin, ctl.wmin[w]);
    kmax = max(kmax, ctl.wmax[w]);
  }
  const unsigned int count = ctl.count;

  // 2. the k-th largest key (none when every positive entry is kept)
  if (count > static_cast<unsigned int>(k)) {
    if (count <= kCap) {
      radix_select<false>(cand, whist, ids, vals, start, len, k, kmin, kmax,
                          ctl);
    } else {
      radix_select<true>(cand, whist, ids, vals, start, len, k, kmin, kmax,
                         ctl);
    }
  }
  __syncthreads();

  // 3. gather the at most k keys at or above the chosen prefix
  const unsigned long long prefix = ctl.prefix;
  const unsigned long long mask = ctl.mask;
  auto keep = [&](unsigned long long key) {
    if ((key & mask) >= prefix) {
      const unsigned int p = atomicAdd(&ctl.sel_count, 1u);
      if (p < static_cast<unsigned int>(k)) sel[p] = key;
    }
  };
  if (count <= kCap) {
    for_each_key<false>(cand, count, ids, vals, start, len, keep);
  } else {
    for_each_key<true>(cand, count, ids, vals, start, len, keep);
  }
  __syncthreads();
  const int n_sel = min(static_cast<int>(ctl.sel_count), k);
  int size = 1;
  while (size < n_sel) size <<= 1;
  for (int i = n_sel + tid; i < size; i += kThreads) sel[i] = 0;
  __syncthreads();
  // 4. bitonic sort of sel[0, size), descending
  for (int span = 2; span <= size; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < size; i += kThreads) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = sel[i];
          const unsigned long long b = sel[partner];
          const bool desc = (i & span) == 0;
          if (desc ? a < b : a > b) {
            sel[i] = b;
            sel[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const int64_t o = static_cast<int64_t>(row) * k + i;
    if (i < n_sel) {
      const unsigned long long key = sel[i];
      out_vals[o] = __uint_as_float(static_cast<unsigned int>(key >> 32));
      out_cols[o] =
          static_cast<int32_t>(~static_cast<unsigned int>(key & 0xffffffffull));
    } else {
      out_vals[o] = 0.0f;
      out_cols[o] = 0;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). ids may be null (the
// ids are then the positions in each row); row_off holds num_rows + 1
// offsets into vals (and ids); out_cols and out_vals are [num_rows, k].
extern "C" int push_topk(const int32_t* ids, const float* vals,
                         const int64_t* row_off, int num_rows, int k,
                         int32_t* out_cols, float* out_vals, void* stream) {
  if (num_rows == 0 || k == 0) return 0;
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      push_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  push_topk_kernel<<<num_rows, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      ids, vals, row_off, k, out_cols, out_vals);
  return static_cast<int>(cudaGetLastError());
}
