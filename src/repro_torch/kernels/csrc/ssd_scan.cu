// Mamba-2 SSD chunked scan for Hopper: y (B,S,H,P) and the final state
// h (B,H,N,P) of h_t = exp(a_t) h_{t-1} + B_t x_t^T, y_t = C_t h_t, from h = 0.
//
// Replaces the JAX package's Pallas TPU kernel kernels/ssd_scan.py (ssd_scan
// -> pallas_call at :98, _kernel at :26). There the chunk axis is the
// sequential inner grid axis and the state lives in VMEM scratch. Here one
// block per (b, h) loops over the sequence in chunks of kT = 64 rows and keeps
// the fp32 state h (N x P) in shared memory. Per chunk, with L = cumsum(a):
//
//   G    = (C B^T) * exp(L_i - L_j) for i >= j, else 0    (kT x kT)
//   y    = G x + exp(L_i) (C h)                            (kT x P)
//   h    = exp(L_last) h + (B * exp(L_last - L))^T x       (N x P)
//
// Every exponent is of a difference that is <= 0, or of L <= 0 itself, and the
// mask is applied before the exponent, so nothing overflows however far L
// falls within a chunk. The chunk length is the kernel's own: in exact
// arithmetic the result does not depend on it. Rows past S are loaded as zeros
// (a = 0, x = 0, B = C = 0), which leave the state unchanged, and are never
// written, so any S runs without padding in device memory. The inputs are read
// through their strides, so the model's bf16 B and C views of the conv output
// need no copy.
//
// Two variants, chosen by kernels/ssd_scan.py::plan:
//
// ssd_scan_kernel_tc (bf16 B and C, N a multiple of 16, P of 8, 16-byte rows):
// the four chunk products on the tensor cores (mma.sync), to fp32 accuracy.
// C B^T is bf16 x bf16 with fp32 accumulation, whose products are exact. The
// fp32 operands are split as v = big + small, big = v rounded to the nearest
// TF32 and small = v - big (exact; the tensor cores read its top 19 bits):
// G x takes three products (small big, big small, big big), C h and
// B^T (w x) two (bf16 is exact in TF32, so only h and w x are split). L is
// summed in fp64. A chunk is two phases between barriers, each warp taking
// equal shares: C B^T, its gate and C h; then G x and the state update (the
// warps of G x take row tiles i and 3 - i of the causal triangle). The next
// chunk's x, a, B and C arrive by cp.async in a second buffer while this one
// computes; every global read is a row-major 16-byte piece, and transposes
// happen in the fragment loads (ldmatrix, .trans for B^T). Within a k-step of
// 8 the TF32 fragments take k in the order 0, 4, 1, 5, 2, 6, 3, 7 (a sum does
// not depend on it), so that a thread's two k values are neighbours in
// memory. Row strides are padded so that the fragment loads hit 32 banks.
// Bound at the mamba2-370m prefill (B4 S2000 H32 P64 G1 N128): bytes, ~140 MB
// at 3.35 TB/s (0.042 ms), over the recurrence's 8.39 GFLOP counted twice for
// the split on the TF32 tensor cores (0.034 ms). It runs at about 6x that
// (PERF.md): each warp loads and splits every fragment it uses, and that work,
// not the tensor cores, sets the pace.
//
// ssd_scan_kernel (any other B/C: fp32, odd N and P, unaligned views): the
// first design, fp32 on the CUDA cores in 4 x 4 register tiles from float4
// shared-memory reads, with C, B (twice: transposed for C B^T, row-major for
// B^T x), x, G and h in 161 KB of shared memory at N = 128, P = 64; L summed
// in fp64, as in the tensor-core kernel. Bound: fp32 operations.
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- generic variant

// Floats of shared memory: h, C^T, B^T, B, x, G^T, then L (fp64, two floats a
// row), exp(L_last - L), exp(L).
inline size_t smem_floats(int N, int P) {
  return static_cast<size_t>(N) * P + 3 * static_cast<size_t>(N) * kT +
         static_cast<size_t>(kT) * P + kT * kT + 4 * kT;
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
  double* Ls = reinterpret_cast<double*>(Gt + kT * kT);  // [kT], on 16 bytes
  float* Ws = reinterpret_cast<float*>(Ls + kT);         // [kT] exp(L_last - L_t)
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
    if (tid < 32) {  // L = inclusive cumsum of a over the chunk, two rows per lane, in fp64
      const int r = 2 * tid;
      const double a0 = r < valid ? ab[(t0 + r) * p.sa[1]] : 0.f;
      const double a1 = r + 1 < valid ? ab[(t0 + r + 1) * p.sa[1]] : 0.f;
      double s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(kFullMask, s, o);
        if (tid >= o) s += v;
      }
      const double l0 = s - a1, l1 = s;
      const double last = __shfl_sync(kFullMask, s, 31);
      Ls[r] = l0;
      Ls[r + 1] = l1;
      Ws[r] = expf(static_cast<float>(last - l0));
      Ws[r + 1] = expf(static_cast<float>(last - l1));
      Es[r] = expf(static_cast<float>(l0));
      Es[r + 1] = expf(static_cast<float>(l1));
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
          out[r] = i >= j ? acc[r][q] * expf(static_cast<float>(Ls[i] - Ls[j])) : 0.f;  // mask, then exp
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
    const float decay = expf(static_cast<float>(Ls[kT - 1]));  // rows past S add 0 to L
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

// ---------------------------------------------------------------- tensor-core variant

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kGStride = kT + 8;  // words a row of G: the 8-byte fragment loads hit 32 banks
constexpr int kSTiles = 20;       // 16 x 8 tiles of C B^T on or below the diagonal of a chunk
constexpr int kSTilesPerWarp = (kSTiles + kTcWarps - 1) / kTcWarps;

// Byte offsets in dynamic shared memory. Two stages of the chunk's inputs
// (x [kT][P+4] fp32, B and C [kT][N+8] bf16, a [kT] fp32), then the state h
// [N][P+4] fp32; the TF32 parts of G [kT][kGStride] (big, then small); C h
// [kT][P+4] fp32; each warp's L [kT] fp64; exp(L_last - L) and exp(L) [kT] fp32.
// repro_ssd_scan_tc_smem reports `total` to kernels/ssd_scan.py::plan.
struct TcLayout {
  int xs, bs, cs, as, stage, h, g, gs, ch, l, w, e, total;
};

__host__ __device__ inline TcLayout tc_layout(int N, int P) {
  TcLayout o;
  o.xs = 0;
  o.bs = kT * (P + 4) * 4;
  o.cs = o.bs + kT * (N + 8) * 2;
  o.as = o.cs + kT * (N + 8) * 2;
  o.stage = o.as + kT * 4;
  o.h = 2 * o.stage;
  o.g = o.h + N * (P + 4) * 4;
  o.gs = o.g + kT * kGStride * 4;
  o.ch = o.gs + kT * kGStride * 4;
  o.l = o.ch + kT * (P + 4) * 4;
  o.w = o.l + kTcWarps * kT * 8;
  o.e = o.w + kT * 4;
  o.total = o.e + kT * 4;
  return o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// D (16 x 8 fp32) += A (16 x 16 bf16) B (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D (16 x 8 fp32) += A (16 x 8 tf32) B (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = big + small to about 2^-21 of v. big is v rounded to the nearest TF32
// (ties away from zero, as cvt.rna.tf32.f32 rounds; the tensor cores would
// drop the low 13 bits of an operand, not round them), in two integer
// operations on the bits rather than on the narrower conversion pipe. small =
// v - big is exact in fp32, and the tensor cores read its top 19 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

struct TcBase {
  const float* x;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
};

// Issues the cp.async copies of the chunk at row t0 into the stage at `st`,
// 16-byte pieces spread over every thread (a thread that issues many waits
// for the SM's outstanding requests to drain).
__device__ __forceinline__ void tc_load_chunk(const SsdArgs& p, const TcBase& base, unsigned char* st,
                                              const TcLayout& o, int t0, int warp, int lane) {
  const int N = p.N, P = p.P, valid = min(kT, p.S - t0);
  float* xs = reinterpret_cast<float*>(st + o.xs);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(st + o.bs);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(st + o.cs);
  const int tid = warp * 32 + lane;
  const int xq = P / 4, bq = N / 8;
  for (int i = tid; i < kT * xq; i += kTcThreads) {
    const int t = i / xq, q = i - t * xq;
    const bool v = t < valid;
    cp_async16(xs + t * (P + 4) + 4 * q, base.x + (v ? t0 + t : 0) * p.sx[1] + 4 * q, v);
  }
  for (int i = tid; i < kT * bq; i += kTcThreads) {
    const int t = i / bq, q = i - t * bq;
    const bool v = t < valid;
    const long long row = v ? t0 + t : 0;
    cp_async16(bs + t * (N + 8) + 8 * q, base.b + row * p.sb[1] + 8 * q, v);
    cp_async16(cs + t * (N + 8) + 8 * q, base.c + row * p.sc[1] + 8 * q, v);
  }
  if (warp == 0)
    for (int t = lane; t < kT; t += 32)
      cp_async4(reinterpret_cast<float*>(st + o.as) + t, base.a + (t < valid ? t0 + t : 0) * p.sa[1], t < valid);
}

// The warp's shares: of y, two row tiles of 16 and NC n-tiles of 8; of h, MD
// m-tiles of 16 state rows and ND n-tiles of 8.
//
// A chunk runs in two phases between barriers. Phase 1: every warp scans L
// itself (fp64), computes its tiles of C B^T, gates them and stores their
// TF32 parts, and computes its tiles of C h (from the state the last chunk
// left) into shared memory. Phase 2: y = G x + exp(L) (C h), stored; then the
// state update, each warp reading and writing only its own tiles of h.
template <int NC, int MD, int ND>
__global__ void __launch_bounds__(kTcThreads, 1) ssd_scan_kernel_tc(SsdArgs p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int N = p.N, P = p.P, S = p.S, H = p.H;
  const TcLayout o = tc_layout(N, P);
  const int xstr = P + 4, bstr = N + 8;  // padded row strides (elements) of x, h and C h, and of B and C
  float* hS = reinterpret_cast<float*>(smem_tc + o.h);
  uint32_t* Gb = reinterpret_cast<uint32_t*>(smem_tc + o.g);    // G, big TF32 parts
  uint32_t* Gsm = reinterpret_cast<uint32_t*>(smem_tc + o.gs);  // G, small TF32 parts
  float* CH = reinterpret_cast<float*>(smem_tc + o.ch);          // C h
  float* Ws = reinterpret_cast<float*>(smem_tc + o.w);
  float* Es = reinterpret_cast<float*>(smem_tc + o.e);

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = warp_uniform(tid >> 5);
  double* Lw = reinterpret_cast<double*>(smem_tc + o.l) + warp * kT;  // this warp's L
  const int gq = lane >> 2, tq = lane & 3;  // fragment row (group) and column (thread in group)
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const int grp = hd / (H / p.G);
  TcBase base;
  base.x = p.x + b * p.sx[0] + hd * p.sx[2];
  base.a = p.a + b * p.sa[0] + hd * p.sa[2];
  base.b = static_cast<const __nv_bfloat16*>(p.b) + b * p.sb[0] + grp * p.sb[2];
  base.c = static_cast<const __nv_bfloat16*>(p.c) + b * p.sc[0] + grp * p.sc[2];
  const long long y_row = static_cast<long long>(H) * P;
  float* yb = p.y + (static_cast<long long>(b) * S * H + hd) * P;
  float* hb = p.h + static_cast<long long>(blockIdx.x) * N * P;

  tc_load_chunk(p, base, smem_tc, o, 0, warp, lane);
  cp_async_commit();

  const int nchunks = (S + kT - 1) / kT;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kT, valid = min(kT, S - t0);
    unsigned char* st = smem_tc + (c & 1) * o.stage;
    const float* xs = reinterpret_cast<const float*>(st + o.xs);
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(st + o.bs);
    const __nv_bfloat16* cs = reinterpret_cast<const __nv_bfloat16*>(st + o.cs);
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the last chunk's reads of the other stage are done
    if (c + 1 < nchunks) tc_load_chunk(p, base, smem_tc + ((c + 1) & 1) * o.stage, o, t0 + kT, warp, lane);
    cp_async_commit();

    // ---- phase 1. L = inclusive cumsum of a, in fp64: where the decay is steep
    // L falls to hundreds within a chunk, and an fp32 L_i - L_j would keep only
    // ~2^-16 of its absolute value. ----
    {
      const float* as = reinterpret_cast<const float*>(st + o.as);  // rows past S hold 0
      const int r = 2 * lane;
      const double a0 = as[r], a1 = as[r + 1];
      double s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(kFullMask, s, off);
        if (lane >= off) s += v;
      }
      const double l0 = s - a1, l1 = s;
      Lw[r] = l0;
      Lw[r + 1] = l1;
      if (warp == 0) {  // for phase 2
        const double last = __shfl_sync(kFullMask, s, 31);
        Ws[r] = expf(static_cast<float>(last - l0));
        Ws[r + 1] = expf(static_cast<float>(last - l1));
        Es[r] = expf(static_cast<float>(l0));
        Es[r + 1] = expf(static_cast<float>(l1));
      }
      __syncwarp();
    }

    // ---- G = (C B^T) * exp(L_i - L_j) for i >= j, else 0 (mask, then exp), as
    // TF32 parts. Tile u of the lower triangle: row tile mi (16 rows), column
    // tile nj (8 columns), nj <= 2 mi + 1; tiles w, w + 8, w + 16 to warp w. ----
#pragma unroll
    for (int k = 0; k < kSTilesPerWarp; ++k) {
      const int u = warp + k * kTcWarps;
      if (u < kSTiles) {
        const int mi = u < 2 ? 0 : u < 6 ? 1 : u < 12 ? 2 : 3, nj = u - mi * (mi + 1);
        const __nv_bfloat16* arow = cs + (16 * mi + (lane & 15)) * bstr + (lane >> 4) * 8;
        const __nv_bfloat16* brow = bs + (8 * nj + (lane & 7)) * bstr + ((lane >> 3) & 1) * 8;
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int k0 = 0; k0 < N; k0 += 16) {
          uint32_t af[4], bf[2];
          ldsm_x4(af, arow + k0);
          ldsm_x2(bf, brow + k0);
          mma_bf16(sacc, af, bf);
        }
        const int j = 8 * nj + 2 * tq;
        const double lj0 = Lw[j], lj1 = Lw[j + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mi + gq + 8 * half;
          const double li = Lw[i];
          const float g0 = i >= j ? sacc[2 * half] * expf(static_cast<float>(li - lj0)) : 0.f;
          const float g1 = i >= j + 1 ? sacc[2 * half + 1] * expf(static_cast<float>(li - lj1)) : 0.f;
          uint2 big, small;
          split_tf32(g0, big.x, small.x);
          split_tf32(g1, big.y, small.y);
          *reinterpret_cast<uint2*>(Gb + i * kGStride + j) = big;
          *reinterpret_cast<uint2*>(Gsm + i * kGStride + j) = small;
        }
      }
    }

    // ---- C h, from the state of the chunk before (zero in the first chunk).
    // Unit u: row tiles lo = u & 1 and hi = 3 - lo, columns NC n-tiles from
    // c0; phase 2 takes the same units for G x. ----
    const int cunits = 2 * (P / (8 * NC));
    if (c > 0) {
      for (int u = warp; u < cunits; u += kTcWarps) {
        const int lo = u & 1, hi = 3 - lo, c0 = (u >> 1) * 8 * NC;
        float inter[2][NC][4] = {};
#pragma unroll 4
        for (int k0 = 0; k0 < N; k0 += 16) {  // two k-steps: C by one ldmatrix a row tile
          uint32_t cpair[2][4];  // per row tile: rows i and i + 8 of k-step k0, then of k0 + 8
#pragma unroll
          for (int r = 0; r < 2; ++r)
            ldsm_x4(cpair[r], cs + (16 * (r ? hi : lo) + (lane & 15)) * bstr + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            const int k = k0 + 8 * sub + 2 * tq;
            uint32_t hbig[NC][2], hsmall[NC][2];
#pragma unroll
            for (int nt = 0; nt < NC; ++nt) {
              const int col = c0 + 8 * nt + gq;
              split_tf32(hS[k * xstr + col], hbig[nt][0], hsmall[nt][0]);
              split_tf32(hS[(k + 1) * xstr + col], hbig[nt][1], hsmall[nt][1]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t top = cpair[r][2 * sub], bot = cpair[r][2 * sub + 1];
              const uint32_t cf[4] = {top << 16, bot << 16, top & 0xffff0000u, bot & 0xffff0000u};
#pragma unroll
              for (int nt = 0; nt < NC; ++nt) {
                mma_tf32(inter[r][nt], cf, hsmall[nt]);
                mma_tf32(inter[r][nt], cf, hbig[nt]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int nt = 0; nt < NC; ++nt) {
              const int i = 16 * (r ? hi : lo) + gq + 8 * half;
              *reinterpret_cast<float2*>(CH + i * xstr + c0 + 8 * nt + 2 * tq) =
                  make_float2(inter[r][nt][2 * half], inter[r][nt][2 * half + 1]);
            }
      }
    }
    __syncthreads();  // G, C h, exp(L_last - L) and exp(L) are ready; every read of the old state is done

    // ---- phase 2. y = G x + exp(L) (C h); each unit's k-steps of G x, 2 (lo + 1)
    // and 2 (hi + 1), add up to 10 for every unit. ----
    const int kvalid = (valid + 7) / 8;  // k-steps that hold a row before S
    for (int u = warp; u < cunits; u += kTcWarps) {
      const int lo = u & 1, hi = 3 - lo, c0 = (u >> 1) * 8 * NC;
      float acc[2][NC][4] = {};
      const int ksteps = min(2 * (hi + 1), kvalid), kshort = 2 * (lo + 1);
#pragma unroll
      for (int ks = 0; ks < kT / 8; ++ks) {
        if (ks >= ksteps) break;
        const int k = 8 * ks + 2 * tq;
        uint32_t xbig[NC][2], xsmall[NC][2];
#pragma unroll
        for (int nt = 0; nt < NC; ++nt) {
          const int col = c0 + 8 * nt + gq;
          split_tf32(xs[k * xstr + col], xbig[nt][0], xsmall[nt][0]);
          split_tf32(xs[(k + 1) * xstr + col], xbig[nt][1], xsmall[nt][1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r == 0 && ks >= kshort) continue;
          const int i = 16 * (r ? hi : lo) + gq;
          const uint2 tb = *reinterpret_cast<const uint2*>(Gb + i * kGStride + k);
          const uint2 bb = *reinterpret_cast<const uint2*>(Gb + (i + 8) * kGStride + k);
          const uint2 ts = *reinterpret_cast<const uint2*>(Gsm + i * kGStride + k);
          const uint2 bsm = *reinterpret_cast<const uint2*>(Gsm + (i + 8) * kGStride + k);
          const uint32_t gbig[4] = {tb.x, bb.x, tb.y, bb.y}, gsmall[4] = {ts.x, bsm.x, ts.y, bsm.y};
#pragma unroll
          for (int nt = 0; nt < NC; ++nt) {
            mma_tf32(acc[r][nt], gsmall, xbig[nt]);
            mma_tf32(acc[r][nt], gbig, xsmall[nt]);
            mma_tf32(acc[r][nt], gbig, xbig[nt]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * (r ? hi : lo) + gq + 8 * half;
          if (i >= valid) continue;
          const float e = Es[i];
#pragma unroll
          for (int nt = 0; nt < NC; ++nt) {
            const int col = c0 + 8 * nt + 2 * tq;
            const float* a = acc[r][nt] + 2 * half;
            float2 q = make_float2(0.f, 0.f);
            if (c > 0) q = *reinterpret_cast<const float2*>(CH + i * xstr + col);
            *reinterpret_cast<float2*>(yb + (t0 + i) * y_row + col) = make_float2(fmaf(e, q.x, a[0]), fmaf(e, q.y, a[1]));
          }
        }
      }
    }

    // ---- h = exp(L_last) h + (B * exp(L_last - L))^T x ----
    // Unit u: state rows n0.. (MD m-tiles), columns p0.. (ND n-tiles).
    const float decay = expf(static_cast<float>(Lw[kT - 1]));  // rows past S add 0 to L
    const bool last = c + 1 == nchunks;
    const int pgroups = P / (8 * ND);
    for (int u = warp; u < (N / (16 * MD)) * pgroups; u += kTcWarps) {
      const int n0 = (u / pgroups) * 16 * MD, p0 = (u % pgroups) * 8 * ND;
      float acc[MD][ND][4];
#pragma unroll
      for (int m = 0; m < MD; ++m)
#pragma unroll
        for (int nt = 0; nt < ND; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = n0 + 16 * m + gq + 8 * half, col = p0 + 8 * nt + 2 * tq;
            float2 hv = make_float2(0.f, 0.f);
            if (c > 0) hv = *reinterpret_cast<const float2*>(hS + row * xstr + col);
            acc[m][nt][2 * half] = decay * hv.x;
            acc[m][nt][2 * half + 1] = decay * hv.y;
          }
#pragma unroll
      for (int t0r = 0; t0r < kT; t0r += 16) {  // rows past S are zeros; two k-steps a pass
        // B^T by ldmatrix.trans: per m-tile, rows t, t + 1 of columns n and n + 8,
        // for k-step t0r and then t0r + 8
        uint32_t bpair[MD][4];
#pragma unroll
        for (int m = 0; m < MD; ++m)
          ldsm_x4_trans(bpair[m], bs + (t0r + (lane & 7) + ((lane >> 4) << 3)) * bstr + n0 + 16 * m +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          const int k = t0r + 8 * sub + 2 * tq;
          const float w0 = Ws[k], w1 = Ws[k + 1];
          uint32_t xbig[ND][2], xsmall[ND][2];
#pragma unroll
          for (int nt = 0; nt < ND; ++nt) {
            const int col = p0 + 8 * nt + gq;
            split_tf32(w0 * xs[k * xstr + col], xbig[nt][0], xsmall[nt][0]);
            split_tf32(w1 * xs[(k + 1) * xstr + col], xbig[nt][1], xsmall[nt][1]);
          }
#pragma unroll
          for (int m = 0; m < MD; ++m) {
            const uint32_t lo16 = bpair[m][2 * sub], hi16 = bpair[m][2 * sub + 1];  // columns n, n + 8
            const uint32_t bf[4] = {lo16 << 16, hi16 << 16, lo16 & 0xffff0000u, hi16 & 0xffff0000u};
#pragma unroll
            for (int nt = 0; nt < ND; ++nt) {
              mma_tf32(acc[m][nt], bf, xsmall[nt]);
              mma_tf32(acc[m][nt], bf, xbig[nt]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MD; ++m)
#pragma unroll
        for (int nt = 0; nt < ND; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = n0 + 16 * m + gq + 8 * half, col = p0 + 8 * nt + 2 * tq;
            const float2 hv = make_float2(acc[m][nt][2 * half], acc[m][nt][2 * half + 1]);
            *reinterpret_cast<float2*>(last ? hb + row * P + col : hS + row * xstr + col) = hv;
          }
    }
  }
  cp_async_wait_all();  // no copy is left in flight at exit
}

// Launch state per device: each kernel's opt-in to its shared memory, made once.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, size_t (&done)[kMaxDevices]) {
  cudaError_t err;
  const int dev = device_slot(err);
  if (dev < 0) return static_cast<int>(err);
  if (done[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {  // more shared memory than a block may have
    cudaGetLastError();     // clear it, so that no later launch reports it
    return static_cast<int>(err);
  }
  done[dev] = smem;
  return 0;
}

template <typename TB>
int launch(const SsdArgs& args, int B, cudaStream_t stream) {
  static size_t done[kMaxDevices] = {};
  const size_t smem = smem_floats(args.N, args.P) * sizeof(float);
  if (int err = opt_in(ssd_scan_kernel<TB>, smem, done)) return err;
  ssd_scan_kernel<TB><<<B * args.H, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int MD, int ND>
int launch_tc(const SsdArgs& args, int B, cudaStream_t stream) {
  static size_t done[kMaxDevices] = {};
  const size_t smem = static_cast<size_t>(tc_layout(args.N, args.P).total);
  if (int err = opt_in(ssd_scan_kernel_tc<NC, MD, ND>, smem, done)) return err;
  ssd_scan_kernel_tc<NC, MD, ND><<<B * args.H, kTcThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// Bytes of shared memory the tensor-core kernel takes at an N x P state.
extern "C" int repro_ssd_scan_tc_smem(int N, int P) { return kern::tc_layout(N, P).total; }

// x (B,S,H,P) and log_dA (B,S,H) fp32, Bm and Cm (B,S,G,N) of `dtype`, all read
// through `strides` (15 element strides: x 4, log_dA 3, Bm 4, Cm 4); y (B,S,H,P)
// and h (B,H,N,P) fp32 contiguous. N and P multiples of 4, H a multiple of G.
// `variant` 0: the generic kernel; 1: the tensor-core kernel, for bf16 B and C
// where kernels/ssd_scan.py::plan allows it (N a multiple of 16, P of 8,
// 16-byte aligned rows; more shared memory than a block may have is refused).
extern "C" int repro_ssd_scan(const void* x, const void* log_dA, const void* bm, const void* cm,
                              void* y, void* h, const long long* strides, int B, int S, int H,
                              int G, int N, int P, int dtype, int variant, void* stream) {
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
  if (variant == 1) {
    if (dtype != kern::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
    if (N % 32 == 0 && P % 32 == 0) return kern::launch_tc<2, 2, 4>(args, B, st);
    return kern::launch_tc<1, 1, 1>(args, B, st);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kern::kBFloat16) return kern::launch<__nv_bfloat16>(args, B, st);
  if (dtype == kern::kFloat32) return kern::launch<float>(args, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
