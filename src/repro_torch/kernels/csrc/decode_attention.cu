// Decode attention for Hopper: one query token per sequence against a
// sequence-major KV cache, GQA, split over the sequence and merged inside one
// launch through a thread-block cluster.
//
// Replaces the JAX package's Pallas TPU kernel kernels/decode_attention.py
// (decode_attention -> pallas_call at :116, _kernel at :28). Bound by bytes:
// the valid part of K and V is read once (at the serve shape, B=4, valid 532,
// Hkv=8, D=128 bf16: 8.7 MB, 2.6 us at 3.35 TB/s). As on the TPU, the query
// heads that share a kv head are served together, so each K/V row is read
// once for the whole group. The TPU walks the cache as the sequential
// innermost grid axis with (m, l, acc) in VMEM; one block per (batch, kv
// head) would leave most of the 132 SMs idle at decode batch sizes (B * Hkv =
// 32 at the serve shape), so here a cluster of `split` blocks (at most 8, the
// portable cluster size) serves each (batch, kv head), each block a
// contiguous range of the valid keys, and the blocks merge their partial
// softmax states through distributed shared memory:
//
//   block i: m_i = max s, l_i = sum 2^(s - m_i), o_i = sum 2^(s - m_i) v
//   merge:   M = max m_i, out = sum 2^(m_i - M) o_i / sum 2^(m_i - M) l_i
//
// What the design does about the bound: a block's K and V rows go to shared
// memory by cp.async.bulk, one copy per row on an mbarrier, in stages
// of 128 keys (at the serve shape a block's ~67 keys are one stage, in flight
// at once, costing no registers; a stage costs three block barriers, so
// fewer, longer stages are faster there than 64-key ones). Scores read K in 16-byte pieces (8
// elements per lane, a row per D/8 lanes rounded up to a power of two: at
// D = 80, 16 lanes of which the last 6 hold zeros; at D = 16, the smoke
// configs' head dim, 2 lanes, so a warp takes 16 rows at a time and the P V
// step 64 key groups) against the group's query heads
// held in registers; P V keeps P in fp32 on the CUDA cores, as the reference
// does. The merge pushes rather than pulls: every block stores its state into
// the shared memory of the rank that owns each share of the outputs, so one
// cluster barrier separates the stores from a merge that reads only local
// shared memory. No workspace and no second kernel are needed. On request
// the cluster's rank 0 also writes each head's natural-log log-sum-exp,
// M ln 2 + ln L, so that a caller can merge the outputs of slices of one
// cache exactly (a mesh that splits the cache over its sequence).
//
// The valid length is an int argument (no device sync per layer); keys past
// it are never read, and the last range may be ragged, so S need not divide a
// tile (the TPU kernel asserts S % 256 == 0, decode_attention.py:91).
//
// Head dims: 16, 32, 64, 80 and 128. At the smoke configs' D = 16 a call is
// bound by launch latency: minitron-8b smoke's step (B=2, H=4, Hkv=2, 48
// slots, valid 41) reads 10.5 KB of K and V, 3.1 ns at 3.35 TB/s.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace kern {
namespace {

constexpr int kMaxRep = 8;        // query heads per kv head
constexpr int kMaxSplit = 8;      // blocks per cluster (portable cluster size)
constexpr int kStageKeys = 128;   // keys per stage of the ring
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 128 * 1024;  // bytes of the ring at most
constexpr int kThreads = 128;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = kThreads / 32;

struct DecodeArgs {
  const void* q;  // (B, H, D) contiguous
  const void* k;  // (B, S, Hkv, D) through strides
  const void* v;
  void* o;        // (B, H, D) contiguous
  float* lse;     // (B, H) fp32, or null: no log-sum-exp is written
  long long ks_b, ks_s, ks_h, vs_b, vs_s, vs_h;
  int H, Hkv, rep, valid, split, stages;
  float scale_log2;  // log2(e) / sqrt(D)
};

// 8 consecutive elements (16 bytes of bf16, 32 of fp32) from shared memory.
template <typename T>
__device__ __forceinline__ void load8(const unsigned char* p, float (&f)[8]) {
  const uint4* u = reinterpret_cast<const uint4*>(p);
  unpack16<T>(u[0], f);
  if constexpr (sizeof(T) == 4) unpack16<T>(u[1], f + 4);
}

// Shared memory: barriers, the ring of K/V stages, fp32 scratch.
template <typename T, int D, int REP>
struct DecodeSmem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = 2 * kStageKeys * kRowBytes;  // K rows, then V rows
  static constexpr int kRing = 128;                               // ring offset (after the barriers)
  // scores [REP][64], p [64][REP], o [REP][D], m, l, alpha [REP], merge weights
  // [kMaxSplit][REP], the ranks' (m, l) [kMaxSplit][2][REP] and o shares
  static constexpr int kScratchFloats =
      2 * REP * kStageKeys + REP * D + (3 + 3 * kMaxSplit) * REP + REP * D + kMaxSplit;
  static size_t bytes(int stages) { return kRing + stages * kStageBytes + kScratchFloats * 4; }
  static int max_stages() {
    const int n = kRingBudget / kStageBytes;
    return n < 1 ? 1 : (n > kMaxStages ? kMaxStages : n);
  }
};

// The lanes of a key row: n rounded up to a power of two, so that a row's
// lanes are an aligned group of the warp that xor shuffles stay inside.
__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  using M = DecodeSmem<T, D, REP>;
  constexpr int LD = D / 8;          // lanes that hold a row's dims, 8 elements each
  constexpr int L = pow2_ceil(LD);   // lanes per key row; lanes LD.. hold zeros (D = 80)
  constexpr int KPW = 32 / L;        // rows a warp takes at a time
  constexpr int G = kThreads / L;    // key groups of the P V step
  constexpr int RB = M::kRowBytes;
  constexpr int EB = 8 * static_cast<int>(sizeof(T));  // bytes of a lane's 8 elements
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + M::kRing;
  float* s_s = reinterpret_cast<float*>(ring + a.stages * M::kStageBytes);  // [REP][kStageKeys]
  float* p_s = s_s + REP * kStageKeys;                                      // [kStageKeys][REP]
  float* o_s = p_s + kStageKeys * REP;                                      // [REP][D]
  float* m_s = o_s + REP * D;
  float* l_s = m_s + REP;
  float* al_s = l_s + REP;
  float* w_s = al_s + REP;             // [kMaxSplit][REP] merge weights
  float* ml_in = w_s + kMaxSplit * REP;  // [kMaxSplit][2][REP] every rank's (m, l)
  float* o_in = ml_in + kMaxSplit * 2 * REP;  // [split][share] every rank's o, this rank's share

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = blockIdx.x / a.split, b = grp / a.Hkv, hk = grp % a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, c = lane % L;
  const bool live = c < LD;  // this lane holds dims 8c..8c+7 of its row
  // This block's keys: an even share of [0, valid), at least 16 when valid allows.
  const int kb = static_cast<int>(static_cast<long long>(rank) * a.valid / a.split);
  const int ke = static_cast<int>(static_cast<long long>(rank + 1) * a.valid / a.split);
  const int nst = (ke - kb + kStageKeys - 1) / kStageKeys;
  const T* K = static_cast<const T*>(a.k) + b * a.ks_b + hk * a.ks_h;
  const T* V = static_cast<const T*>(a.v) + b * a.vs_b + hk * a.vs_h;

  if (tid < a.stages) mbar_init(&full[tid], kThreads);
  if (tid < REP) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    al_s[tid] = 0.f;
  }
  for (int i = tid; i < kStageKeys * REP; i += kThreads) p_s[i] = 0.f;  // heads >= rep stay 0
  fence_barrier_init();
  __syncthreads();
  // Every block of the cluster has started once this barrier completes (its
  // wait comes before the first store into another block's shared memory).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Stage s: one bulk copy per K or V row; copy i is thread i % kThreads's.
  auto issue = [&](int s) {
    const int buf = s % a.stages, k0 = kb + s * kStageKeys, n = min(kStageKeys, ke - k0);
    uint32_t bytes = 0;
    for (int i = tid; i < 2 * kStageKeys; i += kThreads) bytes += i % kStageKeys < n ? RB : 0;
    mbar_arrive_expect_tx(&full[buf], bytes);
    for (int i = tid; i < 2 * kStageKeys; i += kThreads) {
      const int row = i % kStageKeys;
      if (row < n) {
        const T* src = i < kStageKeys ? K + (k0 + row) * a.ks_s : V + (k0 + row) * a.vs_s;
        bulk_load(ring + buf * M::kStageBytes + (i / kStageKeys) * kStageKeys * RB + row * RB, src, RB,
                  &full[buf]);
      }
    }
  };
  for (int s = 0; s < nst && s < a.stages; ++s) issue(s);

  // The group's query heads, this lane's 8 dims, scaled into the log2 domain.
  float qf[REP][8];
  const unsigned char* Qg = static_cast<const unsigned char*>(a.q) +
                            ((static_cast<long long>(b) * a.H + hk * a.rep) * D + 8 * c) * sizeof(T);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < a.rep && live) {
      load8<T>(Qg + r * RB, qf[r]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] *= a.scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }

  // P V: thread (c, kg) sums keys kg, kg + G, ... of dims 8c..8c+7 for every head.
  const int kg = tid / L;
  float acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  for (int s = 0; s < nst; ++s) {
    const int buf = s % a.stages, n = min(kStageKeys, ke - kb - s * kStageKeys);
    mbar_wait(&full[buf], (s / a.stages) & 1);
    const unsigned char* Ks = ring + buf * M::kStageBytes;
    const unsigned char* Vs = Ks + kStageKeys * RB;

    // Scores: KPW rows per warp at a time, L lanes per row. The L partial
    // sums of each head are reduced by a butterfly that also scatters the
    // heads: at each level a lane keeps half of its heads and trades the other
    // half, so REP heads cost about REP + log2(L) shuffles instead of
    // REP * log2(L). Lane c of the row ends with heads head0 .. head0 + cnt - 1.
    for (int j0 = warp * KPW; j0 < n; j0 += kWarps * KPW) {
      const int j = j0 + lane / L;
      float kf[8];
      if (j < n && live) {
        load8<T>(Ks + j * RB + c * EB, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      float sr[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        sr[r] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sr[r] = fmaf(qf[r][e], kf[e], sr[r]);
      }
      int head0 = 0;
      constexpr int kCount = REP >= L ? REP / L : 1;  // heads a lane ends with
#pragma unroll
      for (int o = L / 2, cnt = REP; o > 0; o >>= 1) {
        if (cnt > kCount && cnt > 1) {
          const int half = cnt / 2;
          const bool upper = lane & o;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float keep = upper ? sr[i + half] : sr[i], send = upper ? sr[i] : sr[i + half];
            sr[i] = keep + __shfl_xor_sync(kFullMask, send, o);
          }
          head0 += upper ? half : 0;
          cnt = half;
        } else {
#pragma unroll
          for (int i = 0; i < kCount; ++i) sr[i] += __shfl_xor_sync(kFullMask, sr[i], o);
        }
      }
      if (j < n && (c & (L / (REP / kCount) - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < kCount; ++i) s_s[(head0 + i) * kStageKeys + j] = sr[i];
      }
    }
    __syncthreads();

    // The stage's softmax update, one warp per head.
    for (int r = warp; r < a.rep; r += kWarps) {
      constexpr int PER_LANE = kStageKeys / 32;
      float sv[PER_LANE], mx = kNegInf, sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        sv[i] = lane + 32 * i < n ? s_s[r * kStageKeys + lane + 32 * i] : kNegInf;
        mx = fmaxf(mx, sv[i]);
      }
      const float m_old = m_s[r], mn = fmaxf(m_old, warp_max(mx));
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        if (lane + 32 * i < n) {
          const float pv = exp2f(sv[i] - mn);
          p_s[(lane + 32 * i) * REP + r] = pv;
          sum += pv;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = exp2f(m_old - mn);
        al_s[r] = al;
        m_s[r] = mn;
        l_s[r] = l_s[r] * al + sum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float al = al_s[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= al;
    }
    for (int j = live ? kg : n; j < n; j += G) {
      float vf[8];
      load8<T>(Vs + j * RB + c * EB, vf);
      float pr[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) pr[r] = p_s[j * REP + r];
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);
    }
    __syncthreads();  // the stage buffer and the scratch are free again
    if (s + a.stages < nst) issue(s + a.stages);
  }

  // The block's o: sum the key groups, first within a warp, then over the
  // warps through the (now idle) ring.
#pragma unroll
  for (int o = 16; o >= L; o >>= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] += __shfl_xor_sync(kFullMask, acc[r][e], o);
  float* red = reinterpret_cast<float*>(ring);  // [warp][REP][D]
  if (lane < LD) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * REP + r) * D + 8 * c + e] = acc[r][e];
  }
  __syncthreads();

  // Merge across the cluster. Rank q owns outputs [q * share, (q + 1) * share):
  // every block stores its (m, l) and its o of that share into rank q's
  // shared memory, then each rank weighs the states and writes its share.
  const int nout = a.rep * D, share = (nout + a.split - 1) / a.split;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < nout; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * REP * D + i];
    const int q = i / share;
    *cluster.map_shared_rank(o_in + rank * share + (i - q * share), q) = sum;
  }
  if (tid < a.split * a.rep) {
    const int q = tid / a.rep, r = tid % a.rep;
    float* ml = cluster.map_shared_rank(ml_in + rank * 2 * REP, q);
    ml[r] = m_s[r];
    ml[REP + r] = l_s[r];
  }
  cluster.sync();
  if (tid < a.rep) {
    float mx = kNegInf, lsum = 0.f;
    for (int q = 0; q < a.split; ++q) mx = fmaxf(mx, ml_in[q * 2 * REP + tid]);
    for (int q = 0; q < a.split; ++q) {
      const float w = exp2f(ml_in[q * 2 * REP + tid] - mx);
      w_s[q * REP + tid] = w;
      lsum = fmaf(ml_in[q * 2 * REP + REP + tid], w, lsum);
    }
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;  // no valid key gives 0, as on the TPU
    for (int q = 0; q < a.split; ++q) w_s[q * REP + tid] *= inv;
    // The natural-log log-sum-exp of the scores: the state a merge across
    // slices of the cache needs (-inf where no key is valid, weight 0 there).
    if (a.lse != nullptr && rank == 0)
      a.lse[static_cast<long long>(b) * a.H + hk * a.rep + tid] =
          lsum == 0.f ? __int_as_float(static_cast<int>(0xff800000u)) : mx * kLn2 + logf(lsum);  // -inf
  }
  __syncthreads();
  const int i0 = rank * share, i1 = min(nout, i0 + share);
  T* Og = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.H + hk * a.rep) * D;
  for (int i = i0 + tid; i < i1; i += kThreads) {
    const int r = i / D;
    float out = 0.f;
    for (int q = 0; q < a.split; ++q) out = fmaf(o_in[q * share + (i - i0)], w_s[q * REP + r], out);
    Og[i] = from_float<T>(out);
  }
}

template <typename T, int D, int REP>
int launch(DecodeArgs a, int groups, cudaStream_t stream) {
  using M = DecodeSmem<T, D, REP>;
  const int per_block = (a.valid + a.split - 1) / a.split;
  const int need = (per_block + kStageKeys - 1) / kStageKeys;
  a.stages = need < 1 ? 1 : (need > M::max_stages() ? M::max_stages() : need);
  const size_t smem = M::bytes(a.stages);
  auto kernel = decode_kernel<T, D, REP>;
  // Once per device: the opt-in to the shared memory of the deepest ring.
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err;
  const int dev = device_slot(err);
  if (dev < 0) return static_cast<int>(err);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(M::bytes(M::max_stages())));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * a.split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rep(const DecodeArgs& a, int groups, cudaStream_t stream) {
  return a.rep <= 4 ? launch<T, D, 4>(a, groups, stream) : launch<T, D, kMaxRep>(a, groups, stream);
}

template <typename T>
int launch_dim(const DecodeArgs& a, int groups, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rep<T, 16>(a, groups, stream);
    case 32: return launch_rep<T, 32>(a, groups, stream);
    case 64: return launch_rep<T, 64>(a, groups, stream);
    case 80: return launch_rep<T, 80>(a, groups, stream);
    case 128: return launch_rep<T, 128>(a, groups, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace kern

// q, o: (B, H, D) contiguous; k, v: (B, S, Hkv, D) through strides[6] =
// (k, v) x (batch, seq, head) in elements; only positions < valid are read.
// lse: (B, H) fp32 contiguous, or null (no log-sum-exp written).
// split: blocks per (batch, kv head) cluster, 1..8 (kernels/decode_attention.py
// plans it).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                                      const long long* strides, int B, int H, int Hkv, int D,
                                      int valid, int split, int dtype, void* stream) {
  const int rep = H / Hkv;
  if (rep > kern::kMaxRep || valid < 0 || split < 1 || split > kern::kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  kern::DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.ks_b = strides[0], a.ks_s = strides[1], a.ks_h = strides[2];
  a.vs_b = strides[3], a.vs_s = strides[4], a.vs_h = strides[5];
  a.H = H;
  a.Hkv = Hkv;
  a.rep = rep;
  a.valid = valid;
  a.split = split;
  a.stages = 1;
  a.scale_log2 = kern::kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kern::kBFloat16) return kern::launch_dim<__nv_bfloat16>(a, B * Hkv, D, st);
  if (dtype == kern::kFloat32) return kern::launch_dim<float>(a, B * Hkv, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
