// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math, cast
// back to the input dtype.
//
// Replaces the JAX package's Pallas TPU kernel kernels/rmsnorm.py (rmsnorm ->
// pallas_call at :44, _kernel at :18). Bound by bytes: one read and one write
// of x. One block per row, 16-byte vector loads, the sum of squares reduced
// with warp shuffles and one shared-memory step. The row is read a second time
// for the output pass; at d = 4096 (8 KB in bf16) that read hits L1/L2, so
// device memory sees x once. Rows are not padded to a tile (the Pallas wrapper
// pads them at rmsnorm.py:40-42).
#include "common.cuh"

namespace kern {
namespace {

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = lane < nwarps ? partial[lane] : 0.f;
  return warp_sum(v);
}

template <typename T, bool kVec>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ y, int d, float eps) {
  constexpr int N = Chunk<T>::N;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  if constexpr (kVec) {
    for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
      float f[N];
      unpack16<T>(*reinterpret_cast<const uint4*>(xr + i), f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_float(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  if constexpr (kVec) {
    for (int i = threadIdx.x * N; i < d; i += blockDim.x * N) {
      float f[N];
      unpack16<T>(*reinterpret_cast<const uint4*>(xr + i), f);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = from_float<T>(f[j] * inv * scale[i + j]);
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      yr[i] = from_float<T>(to_float(xr[i]) * inv * scale[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, long long rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int N = Chunk<T>::N;
  const bool vec = d % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int work = vec ? d / N : d;
  const int threads = min(1024, max(32, (work + 31) / 32 * 32));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec) {
    rmsnorm_kernel<T, true><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xt, scale, yt, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<static_cast<unsigned>(rows), threads, 0, stream>>>(xt, scale, yt, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// x, y: (rows, d) contiguous, dtype given by `dtype`; scale: (d,) fp32.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                             float eps, int dtype, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kern::kBFloat16) return kern::launch<__nv_bfloat16>(x, s, y, rows, d, eps, st);
  if (dtype == kern::kFloat32) return kern::launch<float>(x, s, y, rows, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
