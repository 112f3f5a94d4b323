// Flash attention for Hopper: causal / sliding-window / GQA, online softmax.
//
// Replaces the JAX package's Pallas TPU kernel kernels/flash_attention.py
// (flash_attention -> pallas_call at :126, _kernel at :30). It computes the
// same function, not the same blocks: the TPU walks key tiles as the
// sequential innermost grid axis with (m, l, acc) in VMEM scratch; here one
// block owns a (batch*head, query tile) pair and loops over the key tiles
// itself, with (m, l, acc) in registers. The loop starts at the window's first
// tile and stops at the causal diagonal, so fully masked tiles cost nothing.
// The kv head is read as h / rep (GQA) and never repeated in memory. Tensors
// are addressed through (batch, head, seq) strides with a contiguous last dim,
// so the model's (B, S, H, D) projections are read in place. The ragged edge
// is masked: neither Sq nor Sk has to divide a tile (the TPU kernel asserts
// that they do, flash_attention.py:113).
//
// bf16: 4 warps, 64 query rows per block (16 per warp), key tiles of 64.
// S = Q K^T and O += P V run on the tensor cores with mma.sync m16n8k16
// (bf16 in, fp32 accumulate); the S accumulator is re-packed in registers as
// the A operand of the P V product, and V is read transposed by ldmatrix.
// At the slice's prefill shape (B=4, H=32, Hkv=8, S=500, D=128) the bound is
// bytes (q, k, v, o once: 41 MB against 8.2 GFLOP causal); this first version
// loads K/V tiles synchronously, without cp.async/TMA pipelining.
//
// fp32: multiplied in fp32 on the CUDA cores (no TF32), one warp per query
// row, 8 rows per block, key tiles of 32 staged in shared memory, so that the
// fp32 tests hold the reference's 2e-5.
#include "common.cuh"

namespace kern {
namespace {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements: (batch, head, seq); the last dim is contiguous
  long long qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s, os_b, os_h, os_s;
  int H, rep, Sq, Sk, causal, window;  // window <= 0: no window
  float scale_log2;                    // log2(e) / sqrt(D)
};

// Key tiles [lo, hi) that a query tile [q0, q0 + rows) can see.
__device__ __forceinline__ void key_range(const FlashArgs& a, int q0, int rows, int bk, int& lo,
                                          int& hi) {
  hi = a.causal ? min(a.Sk, q0 + rows) : a.Sk;
  lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  lo = lo / bk * bk;
}

__device__ __forceinline__ bool visible(const FlashArgs& a, int qpos, int kpos) {
  return qpos < a.Sq && kpos < a.Sk && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// ---------------------------------------------------------------- bf16, mma.sync

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(FlashArgs a) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;  // LD: padded smem row, conflict-free fragments
  constexpr int NT = BK / 8, DK = D / 16, DN = D / 8, CH = D / 8;
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / a.rep;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs_b + h * a.qs_h;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks_b + hk * a.ks_h;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs_b + hk * a.vs_h;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.os_b + h * a.os_h;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // Q as mma A fragments, straight from global memory (read once per block).
  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < a.Sq ? ld32(Q + r0 * a.qs_s + c) : 0u;
    qf[kk][1] = r1 < a.Sq ? ld32(Q + r1 * a.qs_s + c) : 0u;
    qf[kk][2] = r0 < a.Sq ? ld32(Q + r0 * a.qs_s + c + 8) : 0u;
    qf[kk][3] = r1 < a.Sq ? ld32(Q + r1 * a.qs_s + c + 8) : 0u;
  }

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int lo, hi;
  key_range(a, q0, BQ, BK, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;  // zero past Sk: p = 0 must not meet NaN
      if (k0 + r < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(K + (k0 + r) * a.ks_s + c);
        vv = *reinterpret_cast<const uint4*>(V + (k0 + r) * a.vs_s + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * LD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        mma_bf16(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
    }

    // Mask, scale, and the online-softmax update (rows r0 and r1 of the thread).
    uint32_t ok = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        if (visible(a, e < 2 ? r0 : r1, kpos)) {
          ok |= 1u << (j * 4 + e);
          s[j][e] *= a.scale_log2;
        } else {
          s[j][e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (j * 4 + e)) & 1u ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V: two S accumulator tiles form one A fragment of k = 16 keys.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = v_s + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // Row sums live spread over the 4 threads of a quad.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFullMask, l[i], 1);
    l[i] += __shfl_xor_sync(kFullMask, l[i], 2);
    inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);  // a row with no visible key gives 0
  }
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < a.Sq) {
      *reinterpret_cast<uint32_t*>(O + r0 * a.os_s + c) = pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    }
    if (r1 < a.Sq) {
      *reinterpret_cast<uint32_t*>(O + r1 * a.os_s + c) = pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
    }
  }
}

// ---------------------------------------------------------------- fp32, CUDA cores

template <int D>
__global__ void __launch_bounds__(256) flash_f32_kernel(FlashArgs a) {
  constexpr int ROWS = 8, BK = 32, DL = D / 32;
  __shared__ float q_s[ROWS][D];
  __shared__ float k_s[BK][D + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float v_s[BK][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / a.rep;
  const int q0 = blockIdx.x * ROWS, row = q0 + warp;
  const float* Q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* K = static_cast<const float*>(a.k) + b * a.ks_b + hk * a.ks_h;
  const float* V = static_cast<const float*>(a.v) + b * a.vs_b + hk * a.vs_h;
  float* O = static_cast<float*>(a.o) + b * a.os_b + h * a.os_h;

  for (int c = lane; c < D; c += 32) q_s[warp][c] = row < a.Sq ? Q[row * a.qs_s + c] * a.scale_log2 : 0.f;
  float m = kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  int lo, hi;
  key_range(a, q0, ROWS, BK, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < a.Sk;
      k_s[r][c] = in ? K[(k0 + r) * a.ks_s + c] : 0.f;
      v_s[r][c] = in ? V[(k0 + r) * a.vs_s + c] : 0.f;
    }
    __syncthreads();
    const int kpos = k0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s = fmaf(q_s[warp][c], k_s[lane][c], s);
    const bool ok = visible(a, row, kpos);
    s = ok ? s : kNegInf;
    const float mn = fmaxf(m, warp_max(s));
    const float alpha = exp2f(m - mn);
    const float p = ok ? exp2f(s - mn) : 0.f;
    l = l * alpha + warp_sum(p);
    m = mn;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, v_s[j][lane + 32 * i], acc[i]);
    }
  }
  if (row < a.Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int i = 0; i < DL; ++i) O[row * a.os_s + lane + 32 * i] = acc[i] * inv;
  }
}

template <int D>
int launch(const FlashArgs& a, int B, int dtype, cudaStream_t stream) {
  if (dtype == kBFloat16) {
    const dim3 grid((a.Sq + 63) / 64, B * a.H);
    flash_bf16_kernel<D><<<grid, 128, 0, stream>>>(a);
  } else if (dtype == kFloat32) {
    const dim3 grid((a.Sq + 7) / 8, B * a.H);
    flash_f32_kernel<D><<<grid, 256, 0, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), all addressed through
// strides[12] = (q, k, v, o) x (batch, head, seq) in elements.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     const long long* strides, int B, int H, int Hkv, int Sq,
                                     int Sk, int D, int causal, int window, int dtype,
                                     void* stream) {
  kern::FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.qs_b = strides[0], a.qs_h = strides[1], a.qs_s = strides[2];
  a.ks_b = strides[3], a.ks_h = strides[4], a.ks_s = strides[5];
  a.vs_b = strides[6], a.vs_h = strides[7], a.vs_s = strides[8];
  a.os_b = strides[9], a.os_h = strides[10], a.os_s = strides[11];
  a.H = H;
  a.rep = H / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = kern::kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return kern::launch<32>(a, B, dtype, st);
    case 64: return kern::launch<64>(a, B, dtype, st);
    case 128: return kern::launch<128>(a, B, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
