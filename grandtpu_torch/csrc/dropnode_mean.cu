// K1: gather + DropNode weighted mean for the dense-feature engine.
//
// Replaces the TPU program grandtpu/nn/dropnode.py::random_prop and its
// gather (gather_and_prop), as driven by grandtpu/train/step.py::_forward_k
// (train, K augmentations) and build_eval_step (eval, K = 1, nothing dropped):
//
//   out[k, b, :] = sum_j w[k,b,j] * features[cols[b,j], :] / (sum_j w[k,b,j] + 1e-12)
//   w[k,b,j]     = keep[k,b,j] ? vals[b,j] : 0        (keep == nullptr: all kept)
//
// What bounds it on an H100: the gather. A train step at reddit width reads
// B*Ktop*F*4 = 250*64*602*4 B = 38.5 MB of feature rows, about 11.5 us at
// 3.35 TB/s, and does only 2*K flops per float it loads. So the design reads
// each gathered row ONCE for all K masks: one block per batch row, threads
// striding over F with coalesced row reads, K numerators per feature in
// registers, and the row's (col, masked weight) pairs and K denominators in
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int K>
__global__ void dropnode_mean_kernel(const float* __restrict__ features,
                                     const int32_t* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     const uint8_t* __restrict__ keep,
                                     float* __restrict__ out, int batch,
                                     int ktop, int num_features) {
  extern __shared__ float smem[];
  float* w = smem;                      // [K, ktop] masked weights
  float* den = smem + K * ktop;         // [K] weight mass + 1e-12
  int32_t* row_cols = reinterpret_cast<int32_t*>(den + K);  // [ktop]

  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < ktop; j += blockDim.x) {
    const int64_t bj = static_cast<int64_t>(b) * ktop + j;
    const float v = vals[bj];
    row_cols[j] = cols[bj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool kept =
          keep == nullptr ||
          keep[(static_cast<int64_t>(k) * batch + b) * ktop + j] != 0;
      w[k * ktop + j] = kept ? v : 0.0f;
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int j = 0; j < ktop; ++j) s += w[threadIdx.x * ktop + j];
    den[threadIdx.x] = s + 1e-12f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < num_features; f += blockDim.x) {
    float num[K];
#pragma unroll
    for (int k = 0; k < K; ++k) num[k] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < ktop; ++j) {
      const float x = __ldg(features +
                            static_cast<int64_t>(row_cols[j]) * num_features + f);
#pragma unroll
      for (int k = 0; k < K; ++k) num[k] = fmaf(w[k * ktop + j], x, num[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[(static_cast<int64_t>(k) * batch + b) * num_features + f] =
          num[k] / den[k];
  }
}

template <int K>
cudaError_t launch(const float* features, const int32_t* cols,
                   const float* vals, const uint8_t* keep, float* out,
                   int batch, int ktop, int num_features,
                   cudaStream_t stream) {
  const int threads =
      num_features >= 256 ? 256 : ((num_features + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(K * ktop + K) * sizeof(float) +
                      static_cast<size_t>(ktop) * sizeof(int32_t);
  dropnode_mean_kernel<K><<<batch, threads, smem, stream>>>(
      features, cols, vals, keep, out, batch, ktop, num_features);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). num_aug is K, 1..8;
// keep may be null (eval: every entry kept, num_aug must be 1).
extern "C" int dropnode_mean_f32(const float* features, const int32_t* cols,
                                 const float* vals, const uint8_t* keep,
                                 float* out, int batch, int ktop,
                                 int num_features, int num_aug,
                                 void* stream) {
  if (batch == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_aug) {
    case 1: return launch<1>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 2: return launch<2>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 3: return launch<3>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 4: return launch<4>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 5: return launch<5>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 6: return launch<6>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 7: return launch<7>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    case 8: return launch<8>(features, cols, vals, keep, out, batch, ktop, num_features, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
