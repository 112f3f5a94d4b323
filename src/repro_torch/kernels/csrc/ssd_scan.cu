// Mamba-2 SSD chunked scan for Hopper: y (B,S,H,P) and the final state
// h (B,H,N,P) of h_t = exp(a_t) h_{t-1} + B_t x_t^T, y_t = C_t h_t, from h = 0.
//
// Replaces the JAX package's Pallas TPU kernel kernels/ssd_scan.py (ssd_scan
// -> pallas_call at :98, _kernel at :26). There the chunk axis is the
// sequential inner grid axis and the state lives in VMEM scratch. Here one
// block per (b, h) loops over the sequence in chunks of kT = 64 rows and keeps
// the state h (N x P fp32) in shared memory. Per chunk, with L = cumsum(a):
//
//   G    = (C B^T) * exp(L_i - L_j) for i >= j, else 0    (kT x kT)
//   y    = G x + exp(L_i) (C h)                            (kT x P)
//   h    = exp(L_last) h + (B * exp(L_last - L))^T x       (N x P)
//
// Every exponent is of a difference that is <= 0, or of L <= 0 itself, and the
// mask is applied before the exponent, so nothing overflows however far L
// falls within a chunk. The chunk length is the kernel's own: in exact
// arithmetic the result does not depend on it, and 64 rows keep C, B (twice:
// transposed for C B^T, row-major for B^T x), x, G and h in 161 KB of shared
// memory at N = 128, P = 64. Rows past S are loaded as zeros (a = 0, x = 0,
// B = C = 0), which leave the state unchanged, and are never written, so any S
// runs without padding in device memory.
//
// Bound: fp32 operations on the CUDA cores (at the mamba2-370m prefill,
// B4 S2000 H32 P64 G1 N128, the recurrence's least work of 4 N P FLOPs per head
// and row, 8.39 GFLOP, against ~140 MB moved). The math is
// fp32 throughout, without TF32, to hold the reference's 2e-4. Each thread
// computes 4 x 4 tiles from float4 reads of shared memory. The inputs are read
// through their strides, so the model's bf16 B and C views of the conv output
// need no copy.
#include "common.cuh"

namespace kern {
namespace {

constexpr int kT = 64;          // rows per chunk
constexpr int kThreads = 256;
static_assert(kThreads == (kT / 4) * (kT / 4), "one 4 x 4 tile of G per thread");

struct SsdArgs {
  const float* x;     // (B, S, H, P)
  const float* a;     // (B, S, H)
  const void* b;      // (B, S, G, N)
  const void* c;      // (B, S, G, N)
  float* y;           // (B, S, H, P) contiguous
  float* h;           // (B, H, N, P) contiguous
  long long sx[4], sa[3], sb[4], sc[4];  // element strides
  int S, H, G, N, P;
};

// Floats of shared memory: h, C^T, B^T, B, x, G^T, then L, exp(L_last - L), exp(L).
inline size_t smem_floats(int N, int P) {
  return static_cast<size_t>(N) * P + 3 * static_cast<size_t>(N) * kT +
         static_cast<size_t>(kT) * P + kT * kT + 3 * kT;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename TB>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(SsdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, P = p.P, S = p.S, H = p.H;
  float* hS = smem;            // [N][P]
  float* Ct = hS + N * P;      // [N][kT]
  float* Bt = Ct + N * kT;     // [N][kT]
  float* Bs = Bt + N * kT;     // [kT][N]
  float* xs = Bs + kT * N;     // [kT][P]
  float* Gt = xs + kT * P;     // [kT][kT], Gt[j][i] = G[i][j]
  float* Ls = Gt + kT * kT;    // [kT]
  float* Ws = Ls + kT;         // [kT] exp(L_last - L_t)
  float* Es = Ws + kT;         // [kT] exp(L_t)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const int g = hd / (H / p.G);
  const float* xb = p.x + b * p.sx[0] + hd * p.sx[2];
  const float* ab = p.a + b * p.sa[0] + hd * p.sa[2];
  const TB* bb = static_cast<const TB*>(p.b) + b * p.sb[0] + g * p.sb[2];
  const TB* cb = static_cast<const TB*>(p.c) + b * p.sc[0] + g * p.sc[2];
  const long long y_row = static_cast<long long>(H) * P;
  float* yb = p.y + (static_cast<long long>(b) * S * H + hd) * P;

  for (int i = tid; i < N * P; i += kThreads) hS[i] = 0.f;
  const int P4 = P / 4, N4 = N / 4;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int valid = min(kT, S - t0);
    // ---- load the chunk; rows past S are zeros ----
    for (int i = tid; i < kT * P; i += kThreads) {
      const int t = i / P, q = i - t * P;
      xs[i] = t < valid ? xb[(t0 + t) * p.sx[1] + q * p.sx[3]] : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {  // transposed: consecutive threads, consecutive t
      const int t = i % kT, n = i / kT;
      float bv = 0.f, cv = 0.f;
      if (t < valid) {
        bv = to_float(bb[(t0 + t) * p.sb[1] + n * p.sb[3]]);
        cv = to_float(cb[(t0 + t) * p.sc[1] + n * p.sc[3]]);
      }
      Bt[n * kT + t] = bv;
      Ct[n * kT + t] = cv;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      Bs[i] = t < valid ? to_float(bb[(t0 + t) * p.sb[1] + n * p.sb[3]]) : 0.f;
    }
    if (tid < 32) {  // L = inclusive cumsum of a over the chunk, two rows per lane
      const int r = 2 * tid;
      const float a0 = r < valid ? ab[(t0 + r) * p.sa[1]] : 0.f;
      const float a1 = r + 1 < valid ? ab[(t0 + r + 1) * p.sa[1]] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kFullMask, s, o);
        if (tid >= o) s += v;
      }
      const float l0 = s - a1, l1 = s;
      const float last = __shfl_sync(kFullMask, s, 31);
      Ls[r] = l0;
      Ls[r + 1] = l1;
      Ws[r] = expf(last - l0);
      Ws[r + 1] = expf(last - l1);
      Es[r] = expf(l0);
      Es[r + 1] = expf(l1);
    }
    __syncthreads();

    // ---- G = (C B^T) * exp(L_i - L_j), lower triangle; stored transposed ----
    {
      const int ti = tid / (kT / 4), tj = tid % (kT / 4);  // kT/4 x kT/4 tiles = kThreads
      float acc[4][4] = {};
      if (tj <= ti) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(Ct + n * kT + 4 * ti);
          const float4 bv = ld4(Bt + n * kT + 4 * tj);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(at(cv, r), at(bv, q), acc[r][q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * tj + q;
        float out[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r;
          out[r] = i >= j ? acc[r][q] * expf(Ls[i] - Ls[j]) : 0.f;  // mask, then exp
        }
        st4(Gt + j * kT + 4 * ti, make_float4(out[0], out[1], out[2], out[3]));
      }
    }
    __syncthreads();

    // ---- y = G x + exp(L) (C h) ----
    for (int item = tid; item < (kT / 4) * P4; item += kThreads) {
      const int ti = item / P4, tp = item % P4;
      float acc[4][4] = {}, inter[4][4] = {};
      const int jend = min(4 * ti + 4, valid);  // G[i][j] = 0 for j > i
      for (int j = 0; j < jend; ++j) {
        const float4 gv = ld4(Gt + j * kT + 4 * ti);
        const float4 xv = ld4(xs + j * P + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(at(gv, r), at(xv, q), acc[r][q]);
      }
      if (t0 > 0) {  // the state is still zero in the first chunk
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(Ct + n * kT + 4 * ti);
          const float4 hv = ld4(hS + n * P + 4 * tp);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) inter[r][q] = fmaf(at(cv, r), at(hv, q), inter[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i < valid) {
          const float e = Es[i];
          st4(yb + (t0 + i) * y_row + 4 * tp,
              make_float4(fmaf(e, inter[r][0], acc[r][0]), fmaf(e, inter[r][1], acc[r][1]),
                          fmaf(e, inter[r][2], acc[r][2]), fmaf(e, inter[r][3], acc[r][3])));
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- h = exp(L_last) h + (B * exp(L_last - L))^T x ----
    const float decay = expf(Ls[kT - 1]);  // rows past S add 0 to L
    for (int item = tid; item < N4 * P4; item += kThreads) {
      const int tn = item / P4, tp = item % P4;
      float acc[4][4] = {};
      for (int t = 0; t < valid; ++t) {
        const float4 bv = ld4(Bs + t * N + 4 * tn);
        const float4 xv = ld4(xs + t * P + 4 * tp);
        const float w = Ws[t];
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(at(bv, r), xw[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* row = hS + (4 * tn + r) * P + 4 * tp;
        const float4 hv = ld4(row);
        st4(row, make_float4(fmaf(decay, hv.x, acc[r][0]), fmaf(decay, hv.y, acc[r][1]),
                             fmaf(decay, hv.z, acc[r][2]), fmaf(decay, hv.w, acc[r][3])));
      }
    }
    __syncthreads();  // the next chunk overwrites B and x, and reads the new state
  }

  float* hb = p.h + static_cast<long long>(blockIdx.x) * N * P;
  for (int i = tid; i < N * P; i += kThreads) hb[i] = hS[i];
}

template <typename TB>
int launch(const SsdArgs& args, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(args.N, args.P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {  // more shared memory than a block may have
    cudaGetLastError();     // clear it, so that no later launch reports it
    return static_cast<int>(err);
  }
  ssd_scan_kernel<TB><<<B * args.H, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// x (B,S,H,P) and log_dA (B,S,H) fp32, Bm and Cm (B,S,G,N) of `dtype`, all read
// through `strides` (15 element strides: x 4, log_dA 3, Bm 4, Cm 4); y (B,S,H,P)
// and h (B,H,N,P) fp32 contiguous. N and P multiples of 4, H a multiple of G.
extern "C" int repro_ssd_scan(const void* x, const void* log_dA, const void* bm, const void* cm,
                              void* y, void* h, const long long* strides, int B, int S, int H,
                              int G, int N, int P, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || N <= 0 || P <= 0 || N % 4 || P % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  kern::SsdArgs args;
  args.x = static_cast<const float*>(x);
  args.a = static_cast<const float*>(log_dA);
  args.b = bm;
  args.c = cm;
  args.y = static_cast<float*>(y);
  args.h = static_cast<float*>(h);
  for (int i = 0; i < 4; ++i) args.sx[i] = strides[i];
  for (int i = 0; i < 3; ++i) args.sa[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) args.sb[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) args.sc[i] = strides[11 + i];
  args.S = S;
  args.H = H;
  args.G = G;
  args.N = N;
  args.P = P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kern::kBFloat16) return kern::launch<__nv_bfloat16>(args, B, st);
  if (dtype == kern::kFloat32) return kern::launch<float>(args, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
