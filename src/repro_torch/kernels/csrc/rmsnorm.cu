// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math, cast
// back to the input dtype.
//
// Replaces the JAX package's Pallas TPU kernel kernels/rmsnorm.py (rmsnorm ->
// pallas_call at :44, _kernel at :18). Bound by bytes: one read and one write
// of x. Two kernels, both launched as kernels/rmsnorm.py::plan says:
//
// rmsnorm_kernel<T, VPT> takes a row of 16-byte aligned vectors split into
// `tpr` (a power of two) shares of VPT (1..8) vectors each. A thread holds its
// share of the row in registers: all of its loads are issued before any
// arithmetic, the sum of squares is reduced (warp shuffles; one shared-memory
// step when a row spans warps), and the output is scaled and stored from the
// same registers, so x is read from device memory once. A block serves
// blockDim / tpr rows at a time and walks the rows with a grid stride; each
// thread loads its columns of `scale` into registers once. Loads and stores
// are streaming (evict-first): x is read once and y written once.
//
// rmsnorm_kernel_generic<T, kVec> takes every other row (a width whose vectors
// do not split so, or x, y or scale off 16 bytes): one block per row, 16-byte
// vectors where the width and pointers allow, else scalars, and a second read
// of the row for the output pass (from L1/L2).
//
// Rows are not padded to a tile (the Pallas wrapper pads them at
// rmsnorm.py:40-42). x's rows lie `ld` elements apart, so a slice of a wider
// row is read in place (MLA's kv_norm takes the first 512 of each 576-wide
// dkv row); y is written contiguous.
#include "common.cuh"

namespace kern {
namespace {

constexpr int kMaxThreads = 512;  // threads per block of rmsnorm_kernel (plan's MAX_THREADS)

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

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               long long rows, int d, long long ld, int tpr, float eps) {
  constexpr int N = Chunk<T>::N;
  __shared__ float partial[2][kMaxThreads / 32];
  const int rpb = blockDim.x / tpr;  // rows of the block at a time
  const int sub = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int wpr = tpr >> 5;  // warps per row, where a row spans warps
  const int warp = threadIdx.x >> 5;

  // This thread's columns: vectors t, t + tpr, ..., t + (VPT - 1) tpr of a row.
  float s[VPT][N];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const float4* s4 = reinterpret_cast<const float4*>(scale + (t + k * tpr) * N);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 v = __ldg(s4 + j);
      s[k][4 * j] = v.x, s[k][4 * j + 1] = v.y, s[k][4 * j + 2] = v.z, s[k][4 * j + 3] = v.w;
    }
  }

  int buf = 0;
  const long long stride = static_cast<long long>(gridDim.x) * rpb;
  for (long long base = static_cast<long long>(blockIdx.x) * rpb; base < rows; base += stride) {
    const long long row = base + sub;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * ld) + t;
    uint4 v[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = live ? __ldcs(xr + k * tpr) : make_uint4(0, 0, 0, 0);

    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float f[N];
      unpack16<T>(v[k], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
    if (tpr <= 32) {  // the row's threads are lanes of one warp (tpr a power of two)
      for (int o = tpr >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o);
    } else {  // the row spans wpr warps: one shared-memory step, double-buffered
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) partial[buf][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < wpr; ++w) ss += partial[buf][sub * wpr + w];
      buf ^= 1;
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

    if (live) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * d) + t;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        float f[N];
        unpack16<T>(v[k], f);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < N; ++j) o[j] = from_float<T>(f[j] * inv * s[k][j]);
        __stcs(yr + k * tpr, out);
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void rmsnorm_kernel_generic(const T* __restrict__ x, const float* __restrict__ scale,
                                       T* __restrict__ y, int d, long long ld, float eps) {
  constexpr int N = Chunk<T>::N;
  const T* xr = x + static_cast<long long>(blockIdx.x) * ld;
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
      float f[N], s[N];
      unpack16<T>(*reinterpret_cast<const uint4*>(xr + i), f);
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(scale + i) + j);
        s[4 * j] = v.x, s[4 * j + 1] = v.y, s[4 * j + 2] = v.z, s[4 * j + 3] = v.w;
      }
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = from_float<T>(f[j] * inv * s[j]);
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      yr[i] = from_float<T>(to_float(xr[i]) * inv * scale[i]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, long long rows, int d, long long ld, float eps,
           int vpt, int tpr, int threads, int grid, cudaStream_t stream) {
  constexpr int N = Chunk<T>::N;
  if (ld < d) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(scale)) & 15) == 0 && (ld * sizeof(T)) % 16 == 0;
  // the row-register kernel's row: vpt * tpr aligned vectors, tpr a power of two
  if (vpt != 0 && (!aligned || tpr <= 0 || (tpr & (tpr - 1)) || d != vpt * tpr * N ||
                   threads % tpr || threads % 32 || threads > kMaxThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 g(static_cast<unsigned>(grid)), b(static_cast<unsigned>(threads));
  switch (vpt) {
    case 0:
      if (aligned && d % N == 0) {
        rmsnorm_kernel_generic<T, true><<<g, b, 0, stream>>>(xt, scale, yt, d, ld, eps);
      } else {
        rmsnorm_kernel_generic<T, false><<<g, b, 0, stream>>>(xt, scale, yt, d, ld, eps);
      }
      break;
#define REPRO_RMSNORM_CASE(V) \
    case V: rmsnorm_kernel<T, V><<<g, b, 0, stream>>>(xt, scale, yt, rows, d, ld, tpr, eps); break;
    REPRO_RMSNORM_CASE(1) REPRO_RMSNORM_CASE(2) REPRO_RMSNORM_CASE(3) REPRO_RMSNORM_CASE(4)
    REPRO_RMSNORM_CASE(5) REPRO_RMSNORM_CASE(6) REPRO_RMSNORM_CASE(7) REPRO_RMSNORM_CASE(8)
#undef REPRO_RMSNORM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// x: (rows, d) with rows `ld` >= d elements apart, y: (rows, d) contiguous,
// dtype given by `dtype`; scale: (d,) fp32. The plan
// (kernels/rmsnorm.py::plan): `vpt` 16-byte vectors per thread (0 for the
// generic kernel, which takes 16-byte vectors where d, ld and the pointers
// allow), `tpr` threads per row, `threads` per block, `grid` blocks.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                             long long ld, float eps, int dtype, int vpt, int tpr, int threads,
                             int grid, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kern::kBFloat16) {
    return kern::launch<__nv_bfloat16>(x, s, y, rows, d, ld, eps, vpt, tpr, threads, grid, st);
  }
  if (dtype == kern::kFloat32) {
    return kern::launch<float>(x, s, y, rows, d, ld, eps, vpt, tpr, threads, grid, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
