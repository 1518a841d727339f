// The push mask of the dense-residue GFPush (P1).
//
// Replaces the elementwise part of one hop of the TPU program
// grandtpu/ppr/jax_push.py::_push_block (:49-63); the hop's product
// (pushed @ A) stays K2 over the CSR of A^T (csr_spmm.cu), or a dense f32
// matmul for small graphs, as in grandtpu. The carries are node-major,
// [n, B] for a block of B sources, so K2 takes them as they are. For each
// element (u, b):
//
//   r        = residue[u, b] (+ tele_in[b] where u = src[b]: the previous
//              hop's teleport, which grandtpu adds right after the product)
//   reserve += coef * r                          (f32, rounded twice)
//   pushed   = r >= thr[u] and r > 0 and deg[u] > 0 ? r / deg[u] : 0
//   tele_out[b] += r where deg[u] = 0            (dangling mass)
//
// with thr = rmax * deg in f32 and an IEEE division, as in grandtpu. The
// teleport sum is taken in 62-bit fixed point (each term truncated to a
// multiple of 2^-62) with integer atomics, so it is the same in any order
// and on every run; a float atomicAdd would add in launch order, and one ulp
// can move the next hop's rmax decision. In `final` mode (after the last
// hop) only the teleport and the reserve update run.
//
// What bounds it on an H100: bytes. It reads residue and reserve and writes
// reserve and pushed, 16 bytes an element: 1.9 GB at the reddit stand-in's
// [233000, 512]; the arithmetic is a few operations an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float fixed_to_float(unsigned long long q) {
  return __double2float_rn(__ull2double_rn(q) * 0x1p-62);
}

__global__ void dense_push_mask_kernel(
    const float* __restrict__ residue, float* __restrict__ reserve,
    float* __restrict__ pushed, const unsigned long long* __restrict__ tele_in,
    unsigned long long* __restrict__ tele_out, const int32_t* __restrict__ src,
    const float* __restrict__ deg, const float* __restrict__ thr,
    int64_t num_nodes, int num_sources, float coef, int final) {
  const int64_t total = num_nodes * num_sources;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t u = i / num_sources;
    const int b = static_cast<int>(i - u * num_sources);
    float r = residue[i];
    if (tele_in != nullptr && src[b] == u) {
      r = __fadd_rn(r, fixed_to_float(tele_in[b]));
    }
    reserve[i] = __fadd_rn(reserve[i], __fmul_rn(coef, r));
    if (final) continue;
    const float d = deg[u];
    if (d == 0.0f) {
      if (r > 0.0f) {
        atomicAdd(tele_out + b,
                  __double2ull_rz(static_cast<double>(r) * 0x1p62));
      }
      pushed[i] = 0.0f;
    } else {
      pushed[i] = (r >= thr[u] && r > 0.0f) ? __fdiv_rn(r, d) : 0.0f;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). residue, reserve
// and pushed are [num_nodes, num_sources] f32; tele_in (null on the first
// hop) and tele_out (zeroed by the caller; unused when final) are
// [num_sources] Q62 sums; src [num_sources] int32; deg, thr [num_nodes] f32.
extern "C" int dense_push_mask(const float* residue, float* reserve,
                               float* pushed, const void* tele_in,
                               void* tele_out, const int32_t* src,
                               const float* deg, const float* thr,
                               int num_nodes, int num_sources, float coef,
                               int final, void* stream) {
  const int64_t total = static_cast<int64_t>(num_nodes) * num_sources;
  if (total == 0) return 0;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  dense_push_mask_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      residue, reserve, pushed,
      static_cast<const unsigned long long*>(tele_in),
      static_cast<unsigned long long*>(tele_out), src, deg, thr, num_nodes,
      num_sources, coef, final);
  return static_cast<int>(cudaGetLastError());
}
