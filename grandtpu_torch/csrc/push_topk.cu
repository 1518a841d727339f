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
// and a larger key is a larger value or, at equal values, a smaller id. One
// CTA a row finds the k-th largest key by a radix select, 8 bits a pass from
// the top, with a 256-bin histogram in shared memory; it stops as soon as
// the chosen bin holds exactly the entries still wanted (with distinct
// values, after the four passes over the value bits at most). A last pass
// gathers the at most k selected keys into shared memory, where a bitonic
// sort orders them.
//
// What bounds it on an H100: bytes. It must read every entry of a row once
// (ids and vals) and write k entries; each radix pass reads the row again
// (from L2 when the row fits there). P1's rows are whole reserve columns
// (n = 233,000 at the reddit stand-in, mostly zeros); P2's rows are the
// reserve hash tables, about twice the count of distinct reserve nodes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 1024;

__device__ __forceinline__ unsigned long long topk_key(float v, int32_t id) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned long long>(~static_cast<unsigned int>(id));
}

__global__ void push_topk_kernel(const int32_t* __restrict__ ids,
                                 const float* __restrict__ vals,
                                 const int64_t* __restrict__ row_off, int k,
                                 int32_t* __restrict__ out_cols,
                                 float* __restrict__ out_vals) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long sel[kMaxK];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ unsigned int s_need, s_count;
  __shared__ int s_all, s_done;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t start = row_off[row];
  const int64_t end = row_off[row + 1];
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_need = k;
    s_count = 0;
    s_all = 0;
    s_done = 0;
  }
  __syncthreads();

  // radix select of the k-th largest key among the positive entries
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    const unsigned long long prefix = s_prefix;
    const unsigned long long mask = s_mask;
    for (int64_t j = start + tid; j < end; j += blockDim.x) {
      const float v = vals[j];
      if (!(v > 0.0f)) continue;
      const unsigned long long key =
          topk_key(v, ids ? ids[j] : static_cast<int32_t>(j - start));
      if ((key & mask) == prefix) {
        atomicAdd(&hist[static_cast<unsigned int>(key >> shift) & 255u], 1u);
      }
    }
    __syncthreads();
    if (tid == 0) {
      unsigned int need = s_need;
      if (shift == 56) {
        unsigned int total = 0;
        for (int d = 0; d < 256; ++d) total += hist[d];
        if (total <= need) s_all = 1;   // every positive entry is kept
      }
      if (!s_all) {
        unsigned int above = 0;
        int d = 255;
        for (; d > 0; --d) {
          if (above + hist[d] >= need) break;
          above += hist[d];
        }
        need -= above;
        s_prefix = prefix | (static_cast<unsigned long long>(d) << shift);
        s_mask = mask | (255ull << shift);
        s_need = need;
        if (hist[d] == need) s_done = 1;   // the whole bin is kept
      }
    }
    __syncthreads();
    if (s_all || s_done) break;
  }

  // gather the selected keys: every key whose leading digits are at or
  // above the chosen prefix (at most k of them)
  const unsigned long long prefix = s_prefix;
  const unsigned long long mask = s_mask;
  const bool all = s_all;
  for (int64_t j = start + tid; j < end; j += blockDim.x) {
    const float v = vals[j];
    if (!(v > 0.0f)) continue;
    const unsigned long long key =
        topk_key(v, ids ? ids[j] : static_cast<int32_t>(j - start));
    if (all || (key & mask) >= prefix) {
      // k at most with unique ids; the bound keeps repeated ids in bounds
      const unsigned int p = atomicAdd(&s_count, 1u);
      if (p < static_cast<unsigned int>(k)) sel[p] = key;
    }
  }
  __syncthreads();
  const int count = min(static_cast<int>(s_count), k);
  int size = 1;
  while (size < count) size <<= 1;
  for (int i = count + tid; i < size; i += blockDim.x) sel[i] = 0;
  __syncthreads();
  // bitonic sort of sel[0, size), descending
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < size; i += blockDim.x) {
        const int partner = i ^ stride;
        if (partner > i) {
          const unsigned long long a = sel[i];
          const unsigned long long b = sel[partner];
          const bool desc = (i & len) == 0;
          if (desc ? a < b : a > b) {
            sel[i] = b;
            sel[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += blockDim.x) {
    const int64_t o = static_cast<int64_t>(row) * k + i;
    if (i < count) {
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
  push_topk_kernel<<<num_rows, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ids, vals, row_off, k, out_cols, out_vals);
  return static_cast<int>(cudaGetLastError());
}
