// Decode attention for Hopper: one query token per sequence against a
// sequence-major KV cache, GQA, split over the sequence (flash-decoding).
//
// Replaces the JAX package's Pallas TPU kernel kernels/decode_attention.py
// (decode_attention -> pallas_call at :116, _kernel at :28). Bound by bytes:
// the valid part of K and V is read once. As on the TPU, the query heads that
// share a kv head are served together, so each K/V row is read once for the
// whole group. The TPU walks the cache as the sequential innermost grid axis
// with (m, l, acc) in VMEM; one block per (batch, kv head) would leave most of
// the 132 SMs idle at decode batch sizes (B * Hkv = 32 at the serve shape), so
// here the valid length is cut into chunks of kChunk keys, one block each,
// and a second kernel merges the chunks' partial softmax states:
//
//   chunk i: m_i = max s, l_i = sum 2^(s - m_i), o_i = sum 2^(s - m_i) v
//   merge:   M = max m_i, out = sum 2^(m_i - M) o_i / sum 2^(m_i - M) l_i
//
// The valid length is an int argument (no device sync per layer); keys past
// it are never read, and the last chunk may be ragged, so S need not divide a
// tile (the TPU kernel asserts S % 256 == 0, decode_attention.py:91). The
// partial states live in an fp32 workspace the wrapper allocates.
//
// Chunk kernel, 128 threads: scores with one warp per key (a coalesced row
// read, the dot product reduced by shuffles), the chunk's softmax with one
// warp per query head, then P V with one thread per output dim.
#include "common.cuh"

namespace kern {
namespace {

constexpr int kMaxRep = 8;      // query heads per kv head
constexpr int kChunk = 64;      // keys per block of the chunk kernel
constexpr int kThreads = 128;   // threads of the chunk kernel
constexpr int kWarps = kThreads / 32;

struct DecodeArgs {
  const void* q;  // (B, H, D) contiguous
  const void* k;  // (B, S, Hkv, D) through strides
  const void* v;
  void* o;        // (B, H, D) contiguous
  float* part_o;  // (B * Hkv, nchunk, rep, D) unnormalised chunk outputs
  float* part_ml; // (B * Hkv, nchunk, rep, 2) chunk max (log2 domain) and sum
  long long ks_b, ks_s, ks_h, vs_b, vs_s, vs_h;
  int H, Hkv, rep, valid, nchunk;
  float scale_log2;  // log2(e) / sqrt(D)
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_chunk_kernel(DecodeArgs a) {
  constexpr int EPL = D / 32;         // elements of a row per lane
  constexpr int NG = kThreads / D;    // key groups in the P V step
  __shared__ float q_s[kMaxRep][D];
  __shared__ float p_s[kMaxRep][kChunk];
  __shared__ float red_s[NG][kMaxRep][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, rep = a.rep;
  const int bh = blockIdx.x, b = bh / a.Hkv, hk = bh % a.Hkv, chunk = blockIdx.y;
  const int k0 = chunk * kChunk, n = min(kChunk, a.valid - k0);
  const T* Qg = static_cast<const T*>(a.q) + (static_cast<long long>(b) * a.H + hk * rep) * D;
  const T* K = static_cast<const T*>(a.k) + b * a.ks_b + hk * a.ks_h + k0 * a.ks_s;
  const T* V = static_cast<const T*>(a.v) + b * a.vs_b + hk * a.vs_h + k0 * a.vs_s;

  for (int i = tid; i < rep * D; i += kThreads) q_s[i / D][i % D] = to_float(Qg[i]) * a.scale_log2;
  __syncthreads();

  // Scores: warp w takes keys w, w + kWarps, ...; lane l holds dims l + 32e.
  for (int j = warp; j < n; j += kWarps) {
    float kf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kf[e] = to_float(K[j * a.ks_s + e * 32 + lane]);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(q_s[r][e * 32 + lane], kf[e], s);
        s = warp_sum(s);
        if (lane == 0) p_s[r][j] = s;
      }
    }
  }
  __syncthreads();

  // The chunk's softmax state, one warp per query head.
  float* ml = a.part_ml + (static_cast<long long>(bh) * a.nchunk + chunk) * rep * 2;
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = exp2f(p_s[r][j] - mx);
      p_s[r][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[2 * r] = mx;
      ml[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // P V: thread (g, d) sums keys g, g + NG, ... of output dim d.
  const int g = tid / D, d = tid % D;
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  for (int j = g; j < n; j += NG) {
    const float vv = to_float(V[j * a.vs_s + d]);
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) acc[r] = fmaf(p_s[r][j], vv, acc[r]);
    }
  }
  if constexpr (NG > 1) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) red_s[g][r][d] = acc[r];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          for (int gi = 1; gi < NG; ++gi) acc[r] += red_s[gi][r][d];
        }
      }
    }
  }
  if (g == 0) {
    float* po = a.part_o + (static_cast<long long>(bh) * a.nchunk + chunk) * rep * D;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) po[r * D + d] = acc[r];
    }
  }
}

// One block per (batch, kv head), one thread per (query head, dim).
template <typename T, int D>
__global__ void decode_merge_kernel(DecodeArgs a) {
  const int bh = blockIdx.x, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int r = threadIdx.x / D, d = threadIdx.x % D;
  if (r >= a.rep) return;
  const float* ml = a.part_ml + static_cast<long long>(bh) * a.nchunk * a.rep * 2;
  const float* po = a.part_o + static_cast<long long>(bh) * a.nchunk * a.rep * D;
  float m = kNegInf;
  for (int c = 0; c < a.nchunk; ++c) m = fmaxf(m, ml[(c * a.rep + r) * 2]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < a.nchunk; ++c) {
    const float w = exp2f(ml[(c * a.rep + r) * 2] - m);
    l = fmaf(ml[(c * a.rep + r) * 2 + 1], w, l);
    o = fmaf(po[(c * a.rep + r) * D + d], w, o);
  }
  T* Og = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.H + hk * a.rep + r) * D;
  Og[d] = from_float<T>(l == 0.f ? 0.f : o / l);  // no valid key gives 0, as on the TPU
}

template <typename T, int D>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  const unsigned groups = static_cast<unsigned>(B * a.Hkv);
  if (a.nchunk > 0) {
    decode_chunk_kernel<T, D><<<dim3(groups, a.nchunk), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_merge_kernel<T, D><<<groups, a.rep * D, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace kern

// q, o: (B, H, D) contiguous; k, v: (B, S, Hkv, D) through strides[6] =
// (k, v) x (batch, seq, head) in elements; positions >= valid are masked.
// workspace: B * Hkv * nchunk * (H / Hkv) * (D + 2) floats, nchunk =
// ceil(valid / 64) (kernels/decode_attention.py allocates it).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, float* workspace, int B, int H,
                                      int Hkv, int D, int valid, int dtype, void* stream) {
  const int rep = H / Hkv;
  if (rep > kern::kMaxRep || valid < 0) return static_cast<int>(cudaErrorInvalidValue);
  kern::DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.ks_b = strides[0], a.ks_s = strides[1], a.ks_h = strides[2];
  a.vs_b = strides[3], a.vs_s = strides[4], a.vs_h = strides[5];
  a.H = H;
  a.Hkv = Hkv;
  a.rep = rep;
  a.valid = valid;
  a.nchunk = (valid + kern::kChunk - 1) / kern::kChunk;
  a.part_o = workspace;
  a.part_ml = workspace + static_cast<long long>(B) * Hkv * a.nchunk * rep * D;
  a.scale_log2 = kern::kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kern::kBFloat16) return kern::launch_dim<__nv_bfloat16>(a, B, D, st);
  if (dtype == kern::kFloat32) return kern::launch_dim<float>(a, B, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
