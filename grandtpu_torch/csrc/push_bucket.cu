// The sparse-residue GFPush (P2): one kernel a hop, one for the reserves.
//
// Replaces the TPU program grandtpu/ppr/bucket_push.py::gfpush_bucketed
// (:409): bucket_hop replaces a hop's expansion and dedup, _hop (:141) and
// _dedup_rows (:117); bucket_reserve replaces the reserve log of
// _push_block (:329) and the dedup of _finalize (:262), whose selection is
// push_topk.cu. The math is grandtpu's (reference graph.h:53-131); the TPU
// layout (shape buckets, replay plans, w-wide edge blocks, sort-based
// dedup) is not carried over. For a block of B sources, source b's frontier
// of live residues (node u, value q) lies in its own region of flat arrays,
// and one CTA owns source b from its frontier to its next frontier, so no
// step needs the whole grid. Values are 62-bit fixed point in unsigned
// 64-bit integers (1.0 = 2^62; every residue and reserve is <= 1), so every
// sum is an integer atomicAdd, exact and the same in any order: a float
// atomicAdd would add in launch order, and one ulp can move an rmax
// decision, the next frontier and the top-k.
//
// bucket_hop, for source b (512 threads):
// - Expansion, in tiles of 512 frontier entries. A thread reads one entry
//   (coalesced) and its node's packed record, one aligned 16-byte load of
//   row start, degree and threshold thr[u] = ceil(rmax * deg(u) * 2^62).
//   Its emit count is deg(u) when q >= thr[u] and p = q / deg(u) (integer
//   division) is not 0, 1 when u is dangling (q teleports to src[b]), else
//   0. An exclusive block scan of the counts lays the tile's slots out;
//   thread t then takes slots t, t + 512, ... (four at a time, so that
//   their loads overlap) and finds each slot's entry by a binary search
//   over the scan in shared memory. Neighbouring threads read neighbouring
//   neighbour ids, and a hub's list is spread over the whole CTA instead
//   of one thread.
// - The table: open addressing with linear probing over a power-of-two
//   capacity (a mask, no modulo), int32 keys claimed by atomicCAS, u64
//   values summed by atomicAdd; a thread's four inserts probe together, so
//   their reads and atomics overlap. It lives in dynamic shared memory when
//   the source's expansion slots exp[b] are at most 3/4 of the shared
//   table (capacity min(kSmemSlots, pow2 >= 2 * exp[b]), load <= 3/4);
//   else in a table of pow2 >= 2 * exp[b] slots in the source's region (4 *
//   exp[b] slots) of a global scratch table, at offsets computed on the
//   device from exp (bucket_push.table_layout, whose SMEM_SLOTS is
//   kSmemSlots). Both are this kernel, chosen per CTA; the CTA fills its
//   own table, so no fill launch precedes it. A CTA whose layout gives it
//   less room than its slots need, or whose table fills up, writes nothing
//   past its regions and sets the launch's error word, on which the wrapper
//   raises: no insert is dropped silently.
// - Compaction without a scan of the table: the thread that claims a slot
//   appends (node, slot) to source b's region of the next frontier (exp[b]
//   entries: the distinct targets never exceed the inserts, which never
//   exceed exp[b]), warp-aggregated (__ballot_sync / __popc, one shared
//   atomicAdd a warp). After a __syncthreads() the same CTA walks that
//   dense list once: each entry's value from its slot, and its node's
//   record for the next hop's slot count (independent loads, unrolled, so
//   they overlap), summed by warp shuffles and one shared atomicAdd a
//   warp. A table scan would read 2-4 slots an entry, one round trip at a
//   time, which made the sources with a global table the slowest CTAs.
//
// bucket_reserve, for source b: every hop's frontier of the reserve log,
// passed in one launch as a device table of (ids, q, off, cnt, coef) rows,
// adds trunc(coef_i * q) (__dmul_rn, __double2ull_rz: the plain version's
// float64 product and truncation) at its own node into the source's table,
// in shared memory under the same rule with exp replaced by the log's
// entries, else in a global region, with the same claim list. The
// distinct reserves are written as (id, f32 value =
// __double2float_rn(v * 2^-62)) and, on request, the u64 sums, followed
// by id -1 and 0 up to the region's end: push_topk's layout.
//
// Sizes: 512 threads a CTA and a shared table of kSmemSlots = 8192 slots
// (96 KB of table and 8 KB of tile arrays: two CTAs an SM, 32 warps
// resident, at most 64 registers a thread), so a source of up to 6,144
// expansion slots stays in shared memory. A 16,384-slot table would keep
// sources of up to 12,288 slots there, but at one CTA an SM, which
// leaves half the warps to hide the record reads of the many small
// sources; the chosen size favours the common source.
//
// What bounds them on an H100: bytes, and the latency of the dependent
// random reads. A hop must read its frontier (12 bytes an entry), one
// record an entry (16 bytes, from a random node: a 32-byte sector), the
// neighbour ids of its slots (4 bytes a slot) and write the next frontier
// (12 bytes an entry) with one record read an out entry. A global table
// adds 24 bytes a slot (filled, then read back): traffic of this design,
// not of the function. The arithmetic is a few integer operations a slot
// and one 64-bit division an entry. The design keeps the table's atomics
// in shared memory (no table traffic at all in device memory for a source
// that fits), and the record reads are the only loads that depend on
// another load.
//
// Why every output is bit for bit the plain version's: every sum is an
// exact integer sum, so neither the order of the atomics nor the slot a
// key lands in changes a value; within a source the order of the next
// frontier and of the reserves depends on the schedule, but no result
// does: the next hop sums again, and push_topk orders by (value, id).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemSlots = 8192;         // 96 KB of table: two CTAs an SM
constexpr int kSmemBytes = kSmemSlots * (sizeof(uint64_t) + sizeof(int32_t));
constexpr int kUnroll = 4;               // expansion slots a thread at once
constexpr int32_t kEmpty = -1;
// bits of a launch's error word
constexpr int kErrLayout = 1;            // a region too small for the slots
constexpr int kErrFull = 2;              // a table or an output region full

struct HopShared {
  int start[kThreads + 1];    // the tile's exclusive scan of emit counts
  int lo[kThreads];           // each entry's row start; -1: dangling
  u64 p[kThreads];            // each entry's pushed value
  int warp_sums[kWarps];
  unsigned int cnt;           // entries appended to the next frontier
  u64 exp;                    // the next hop's expansion slots
};

__device__ __forceinline__ void load_record(const longlong2* rec, int32_t u,
                                            int32_t& start, int32_t& deg,
                                            u64& thr) {
  const longlong2 r = __ldg(rec + u);
  start = static_cast<int32_t>(r.x & 0xffffffffll);
  deg = static_cast<int32_t>(r.x >> 32);
  thr = static_cast<u64>(r.y);
}

__device__ __forceinline__ uint32_t pow2_at_least(uint32_t x) {
  return x <= 1 ? 1u : 1u << (32 - __clz(x - 1));
}

// The capacity of a global table for n inserts: the smallest power of two
// >= 2 n (and >= 64); table_layout's region of 4 n slots holds it. A
// shared table holds at most kSmemSlots of it (n <= 3/4 of kSmemSlots).
__device__ __forceinline__ int64_t table_capacity(int64_t n) {
  return pow2_at_least(static_cast<uint32_t>(2 * n < 64 ? 64 : 2 * n));
}

__device__ __forceinline__ uint32_t smem_capacity(int64_t n) {
  const int64_t cap = table_capacity(n);
  return static_cast<uint32_t>(cap < kSmemSlots ? cap : kSmemSlots);
}

// Whether a CTA's regions hold n inserts: its output region (room) and its
// table, in a global region of g_slots slots or, when g_slots is 0, in
// shared memory. A CTA that fails sets kErrLayout and writes nothing.
__device__ __forceinline__ bool regions_fit(int64_t n, int64_t room,
                                            int64_t g_slots) {
  if (room < n || n > (1ll << 30)) return false;
  return g_slots > 0 ? g_slots >= table_capacity(n)
                     : 4 * n <= 3 * static_cast<int64_t>(kSmemSlots);
}

__device__ __forceinline__ uint32_t hash_slot(int32_t key, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(key) * 0x9E3779B1u;
  return (h ^ (h >> 15)) & mask;
}

// Adds add[r] at key[r] (r < kUnroll; kEmpty keys are skipped) in a shared
// or a global table (the caller's pointer lets the compiler emit
// shared-memory atomics for the first after inlining). The kUnroll probes
// are in flight together: their reads, then their claims (atomicCAS), then
// their adds. A thread that claims a slot appends (key, slot) to the
// source's output with claim(pos, key, slot), one shared atomicAdd on cnt a
// warp (__ballot_sync / __popc over the lanes present), so the table is
// never scanned: the output is the list of its live slots. An insert that
// finds no slot sets kErrFull in *err.
template <class Claim>
__device__ __forceinline__ void table_insert(int32_t* keys, u64* vals,
                                             uint32_t mask,
                                             const int32_t (&key)[kUnroll],
                                             const u64 (&add)[kUnroll],
                                             unsigned int* cnt, int* err,
                                             Claim claim) {
  const int lane = threadIdx.x & 31;
  uint32_t h[kUnroll];
  bool open[kUnroll];
#pragma unroll
  for (int r = 0; r < kUnroll; ++r) {
    open[r] = key[r] != kEmpty;
    h[r] = hash_slot(key[r], mask);
  }
  // the capacity exceeds the inserts, so a free slot is always found; the
  // bound keeps a table with too many inserts from spinning
  for (uint32_t probe = 0; probe <= mask; ++probe) {
    int32_t prev[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      prev[r] = open[r] ? *reinterpret_cast<volatile int32_t*>(keys + h[r])
                        : 0;
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (open[r] && prev[r] == kEmpty) {
        prev[r] = atomicCAS(keys + h[r], kEmpty, key[r]);
      }
    }
    bool again = false;
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const bool claimed = open[r] && prev[r] == kEmpty;
      const unsigned int present = __activemask();
      const unsigned int claims = __ballot_sync(present, claimed);
      if (claims != 0) {
        const int leader = __ffs(claims) - 1;
        unsigned int base = 0;
        if (lane == leader) base = atomicAdd(cnt, __popc(claims));
        base = __shfl_sync(present, base, leader);
        if (claimed) {
          claim(base + __popc(claims & ((1u << lane) - 1u)), key[r], h[r]);
        }
      }
      if (!open[r]) continue;
      if (claimed || prev[r] == key[r]) {
        atomicAdd(vals + h[r], add[r]);
        open[r] = false;
      } else {
        h[r] = (h[r] + 1) & mask;
        again = true;
      }
    }
    if (!again) return;
  }
  atomicOr(err, kErrFull);
}

__device__ __forceinline__ void table_fill(int32_t* keys, u64* vals,
                                           uint32_t cap) {
  for (uint32_t i = threadIdx.x; i < cap; i += kThreads) {
    keys[i] = kEmpty;
    vals[i] = 0;
  }
}

// Exclusive scan of v over the block; *total gets the sum. Ends with a
// __syncthreads(), after which warp_sums may be reused.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  const int before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ void hop_source(
    int32_t* keys, u64* vals, uint32_t cap, HopShared& sh,
    const int32_t* __restrict__ f_ids, const u64* __restrict__ f_q,
    int64_t f0, int64_t cnt, int32_t src_b, const longlong2* rec,
    const int32_t* __restrict__ indices, int32_t* __restrict__ o_ids,
    u64* __restrict__ o_q, int64_t room, int* err) {
  const uint32_t mask = cap - 1;
  table_fill(keys, vals, cap);
  __syncthreads();
  for (int64_t t0 = 0; t0 < cnt; t0 += kThreads) {
    const int64_t j = t0 + threadIdx.x;
    int emit = 0;
    int lo = -1;
    u64 p = 0;
    if (j < cnt) {
      const int32_t u = f_ids[f0 + j];
      const u64 q = f_q[f0 + j];
      int32_t start, deg;
      u64 thr;
      load_record(rec, u, start, deg, thr);
      if (deg == 0) {                    // dangling: teleport to the source
        emit = 1;
        p = q;
      } else if (q >= thr) {             // else pruned: drained, not pushed
        p = q / static_cast<u64>(deg);
        if (p != 0) {
          emit = deg;
          lo = start;
        }
      }
    }
    int total;
    const int first = block_exclusive_scan(emit, sh.warp_sums, &total);
    sh.start[threadIdx.x] = first;
    sh.lo[threadIdx.x] = lo;
    sh.p[threadIdx.x] = p;
    __syncthreads();
    const int n_tile = static_cast<int>(cnt - t0 < kThreads ? cnt - t0
                                                            : kThreads);
    // kUnroll slots a thread at a time: their neighbour-id loads are in
    // flight together before the table adds that need them
    for (int s0 = threadIdx.x; s0 < total; s0 += kThreads * kUnroll) {
      int32_t key[kUnroll];
      u64 add[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int s = s0 + r * kThreads;
        key[r] = kEmpty;
        add[r] = 0;
        if (s < total) {
          int a = 0, z = n_tile;         // the last entry starting at <= s
          while (z - a > 1) {
            const int m = (a + z) >> 1;
            if (sh.start[m] <= s) a = m; else z = m;
          }
          const int row = sh.lo[a];
          key[r] = row < 0 ? src_b
                           : __ldg(indices + static_cast<int64_t>(row) +
                                   (s - sh.start[a]));
          add[r] = sh.p[a];
        }
      }
      // a claimed slot's index waits in o_q until the sums are complete
      table_insert(keys, vals, mask, key, add, &sh.cnt, err,
                   [&](unsigned int pos, int32_t k, uint32_t slot) {
                     if (pos >= room) {
                       atomicOr(err, kErrFull);
                       return;
                     }
                     o_ids[pos] = k;
                     o_q[pos] = slot;
                   });
    }
    __syncthreads();
  }
  // the next frontier's values from the table, and the next hop's slots
  // from each entry's record: a dense loop whose loads overlap
  const int n_out = static_cast<int>(sh.cnt < room ? sh.cnt : room);
  u64 my_exp = 0;
#pragma unroll 4
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    const u64 q = vals[static_cast<uint32_t>(o_q[j])];
    o_q[j] = q;
    int32_t start, deg;
    u64 thr;
    load_record(rec, o_ids[j], start, deg, thr);
    my_exp += deg == 0 ? 1ull : (q >= thr ? static_cast<u64>(deg) : 0ull);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    my_exp += __shfl_down_sync(0xffffffffu, my_exp, d);
  }
  if ((threadIdx.x & 31) == 0 && my_exp != 0) atomicAdd(&sh.exp, my_exp);
}

__global__ void __launch_bounds__(kThreads, 2) bucket_hop_kernel(
    const int32_t* __restrict__ f_ids, const u64* __restrict__ f_q,
    const int64_t* __restrict__ f_off, const int64_t* __restrict__ f_cnt,
    const int64_t* __restrict__ f_exp, const int32_t* __restrict__ src,
    const longlong2* __restrict__ rec, const int32_t* __restrict__ indices,
    const int64_t* __restrict__ g_off, int32_t* __restrict__ g_keys,
    u64* __restrict__ g_vals, const int64_t* __restrict__ o_off,
    int32_t* __restrict__ o_ids, u64* __restrict__ o_q,
    int64_t* __restrict__ o_cnt, int64_t* __restrict__ o_exp,
    int* __restrict__ err) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ HopShared sh;
  const int b = blockIdx.x;
  const int64_t cnt = f_cnt[b];
  const int64_t slots = f_exp[b];
  if (cnt == 0 || slots == 0) {
    if (threadIdx.x == 0) {
      o_cnt[b] = 0;
      o_exp[b] = 0;
    }
    return;
  }
  if (threadIdx.x == 0) {
    sh.cnt = 0;
    sh.exp = 0;
  }
  const int64_t o0 = o_off[b];
  const int64_t room = o_off[b + 1] - o0;
  const int64_t gbase = g_off[b];
  const int64_t region = g_off[b + 1] - gbase;
  if (!regions_fit(slots, room, region)) {
    if (threadIdx.x == 0) {
      atomicOr(err, kErrLayout);
      o_cnt[b] = 0;
      o_exp[b] = 0;
    }
    return;
  }
  if (region > 0) {
    hop_source(g_keys + gbase, g_vals + gbase,
               static_cast<uint32_t>(table_capacity(slots)), sh, f_ids, f_q,
               f_off[b], cnt, src[b], rec, indices, o_ids + o0, o_q + o0,
               room, err);
  } else {
    u64* s_vals = smem;
    int32_t* s_keys = reinterpret_cast<int32_t*>(smem + kSmemSlots);
    hop_source(s_keys, s_vals, smem_capacity(slots), sh, f_ids, f_q,
               f_off[b], cnt, src[b], rec, indices, o_ids + o0, o_q + o0,
               room, err);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    o_cnt[b] = sh.cnt < room ? sh.cnt : room;
    o_exp[b] = static_cast<int64_t>(sh.exp);
  }
}

// One row of the reserve log's device table: pointers to a hop's frontier
// (ids int32, q u64, off and cnt int64 [B]) and the bits of its coef.
struct LogRow {
  long long ids, q, off, cnt, coef;
};

__device__ __forceinline__ void reserve_source(
    int32_t* keys, u64* vals, uint32_t cap, unsigned int* s_cnt,
    const LogRow* __restrict__ hops, int num_hops, int b,
    int32_t* __restrict__ o_ids, u64* __restrict__ o_sum,
    float* __restrict__ o_f, int64_t room, int* err) {
  const uint32_t mask = cap - 1;
  table_fill(keys, vals, cap);
  __syncthreads();
  for (int i = 0; i < num_hops; ++i) {
    const LogRow r = hops[i];
    const int32_t* ids = reinterpret_cast<const int32_t*>(r.ids);
    const u64* q = reinterpret_cast<const u64*>(r.q);
    const int64_t f0 = reinterpret_cast<const int64_t*>(r.off)[b];
    const int64_t cnt = reinterpret_cast<const int64_t*>(r.cnt)[b];
    const double coef = __longlong_as_double(r.coef);
    for (int64_t j0 = threadIdx.x; j0 < cnt; j0 += kThreads * kUnroll) {
      int32_t key[kUnroll];
      u64 add[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t j = j0 + k * kThreads;
        key[k] = kEmpty;
        add[k] = 0;
        if (j < cnt) {
          add[k] =
              __double2ull_rz(__dmul_rn(coef, __ull2double_rn(q[f0 + j])));
          if (add[k] != 0) key[k] = ids[f0 + j];
        }
      }
      // a claimed slot's index waits in o_f until the sums are complete
      table_insert(keys, vals, mask, key, add, s_cnt, err,
                   [&](unsigned int pos, int32_t id, uint32_t slot) {
                     if (pos >= room) {
                       atomicOr(err, kErrFull);
                       return;
                     }
                     o_ids[pos] = id;
                     o_f[pos] = __uint_as_float(slot);
                   });
    }
  }
  __syncthreads();
  const int n_out = static_cast<int>(*s_cnt < room ? *s_cnt : room);
#pragma unroll 4
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    const u64 v = vals[__float_as_uint(o_f[j])];
    o_f[j] = __double2float_rn(__ull2double_rn(v) * 0x1p-62);
    if (o_sum != nullptr) o_sum[j] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2) bucket_reserve_kernel(
    const LogRow* __restrict__ hops, int num_hops,
    const int64_t* __restrict__ r_off, const int64_t* __restrict__ g_off,
    int32_t* __restrict__ g_keys, u64* __restrict__ g_vals,
    int32_t* __restrict__ o_ids, u64* __restrict__ o_sum,
    float* __restrict__ o_f, int64_t* __restrict__ o_cnt,
    int* __restrict__ err) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ unsigned int s_cnt;          // distinct reserves appended
  const int b = blockIdx.x;
  const int64_t o0 = r_off[b];
  const int64_t n = r_off[b + 1] - o0;
  // the inserts: the log's entries of source b
  int64_t inserts = 0;
  for (int i = 0; i < num_hops; ++i) {
    inserts += reinterpret_cast<const int64_t*>(hops[i].cnt)[b];
  }
  const int64_t gbase = g_off[b];
  const int64_t region = g_off[b + 1] - gbase;
  if (inserts == 0 || !regions_fit(inserts, n, region)) {
    if (threadIdx.x == 0) {
      if (inserts != 0) atomicOr(err, kErrLayout);
      o_cnt[b] = 0;
    }
    for (int64_t j = threadIdx.x; j < n; j += kThreads) {
      o_ids[o0 + j] = kEmpty;
      o_f[o0 + j] = 0.0f;
      if (o_sum != nullptr) o_sum[o0 + j] = 0;
    }
    return;
  }
  if (threadIdx.x == 0) s_cnt = 0;
  u64* sums = o_sum == nullptr ? nullptr : o_sum + o0;
  if (region > 0) {
    reserve_source(g_keys + gbase, g_vals + gbase,
                   static_cast<uint32_t>(table_capacity(inserts)), &s_cnt,
                   hops, num_hops, b, o_ids + o0, sums, o_f + o0, n, err);
  } else {
    u64* s_vals = smem;
    int32_t* s_keys = reinterpret_cast<int32_t*>(smem + kSmemSlots);
    reserve_source(s_keys, s_vals, smem_capacity(inserts), &s_cnt, hops,
                   num_hops, b, o_ids + o0, sums, o_f + o0, n, err);
  }
  __syncthreads();
  const int64_t live = s_cnt < n ? s_cnt : n;
  for (int64_t j = live + threadIdx.x; j < n; j += kThreads) {
    o_ids[o0 + j] = kEmpty;
    o_f[o0 + j] = 0.0f;
    if (sums != nullptr) sums[j] = 0;
  }
  if (threadIdx.x == 0) o_cnt[b] = live;
}

// Lets kernel take kSmemBytes of dynamic shared memory on the current
// device (set at each launch: it is a host call of about a microsecond).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  return e;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success). Values (f_q,
// o_q, g_vals, o_sum) are Q62 unsigned 64-bit integers. Source b's frontier
// is f_ids/f_q[f_off[b] : f_off[b] + f_cnt[b]] with f_exp[b] expansion
// slots; rec holds 16 bytes a node: (row start int32, degree int32,
// threshold u64). Its global table, if any, lies in g_keys/g_vals[g_off[b]
// : g_off[b + 1]] (4 f_exp[b] slots, filled by the kernel); else it uses
// kSmemSlots of shared memory, which holds f_exp[b] <= 3/4 kSmemSlots. The
// next frontier goes to o_ids/o_q[o_off[b] : o_off[b] + o_cnt[b]] (the
// region holds f_exp[b] entries), o_exp[b] its slots. *err (zeroed by the
// caller) gets kErrLayout if a source's regions are smaller than that,
// kErrFull if a table or an output region filled up.
extern "C" int bucket_hop(const int32_t* f_ids, const void* f_q,
                          const int64_t* f_off, const int64_t* f_cnt,
                          const int64_t* f_exp, const int32_t* src,
                          const void* rec, const int32_t* indices,
                          const int64_t* g_off, int32_t* g_keys, void* g_vals,
                          const int64_t* o_off, int32_t* o_ids, void* o_q,
                          int64_t* o_cnt, int64_t* o_exp, int* err,
                          int num_sources, void* stream) {
  if (num_sources == 0) return 0;
  const cudaError_t attr = allow_smem(bucket_hop_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bucket_hop_kernel<<<num_sources, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      f_ids, static_cast<const u64*>(f_q), f_off, f_cnt, f_exp, src,
      static_cast<const longlong2*>(rec), indices, g_off, g_keys,
      static_cast<u64*>(g_vals), o_off, o_ids, static_cast<u64*>(o_q), o_cnt,
      o_exp, err);
  return static_cast<int>(cudaGetLastError());
}

// hops: num_hops rows of 5 int64 (ids, q, off, cnt pointers and the bits of
// a float64 coef); the tables as for bucket_hop, with the log's entries of
// source b in place of f_exp[b]. Source b's reserves go to o_ids/o_f (and
// o_sum unless null) [r_off[b] : r_off[b + 1]], a region of at least the
// log's entries of b: o_cnt[b] distinct (id, value) pairs, then id -1 and
// 0. *err as for bucket_hop.
extern "C" int bucket_reserve(const void* hops, int num_hops,
                              const int64_t* r_off, const int64_t* g_off,
                              int32_t* g_keys, void* g_vals, int32_t* o_ids,
                              void* o_sum, float* o_f, int64_t* o_cnt,
                              int* err, int num_sources, void* stream) {
  if (num_sources == 0) return 0;
  const cudaError_t attr = allow_smem(bucket_reserve_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bucket_reserve_kernel<<<num_sources, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LogRow*>(hops), num_hops, r_off, g_off, g_keys,
      static_cast<u64*>(g_vals), o_ids, static_cast<u64*>(o_sum), o_f, o_cnt,
      err);
  return static_cast<int>(cudaGetLastError());
}

// What the card gives each kernel: out[0..2] bucket_hop's resident CTAs an
// SM, static shared bytes and registers a thread, out[3..5]
// bucket_reserve's, out[6] the shared table's slots (kSmemSlots).
extern "C" int bucket_push_occupancy(int* out) {
  cudaError_t e = allow_smem(bucket_hop_kernel);
  if (e == cudaSuccess) e = allow_smem(bucket_reserve_kernel);
  cudaFuncAttributes a;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, bucket_hop_kernel, kThreads, kSmemBytes);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, bucket_hop_kernel);
  if (e == cudaSuccess) {
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = a.numRegs;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 3, bucket_reserve_kernel, kThreads, kSmemBytes);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, bucket_reserve_kernel);
  if (e == cudaSuccess) {
    out[4] = static_cast<int>(a.sharedSizeBytes);
    out[5] = a.numRegs;
  }
  out[6] = kSmemSlots;
  return static_cast<int>(e);
}
