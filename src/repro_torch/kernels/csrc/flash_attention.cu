// Flash attention for Hopper: causal / sliding-window / GQA, online softmax.
//
// Replaces the JAX package's Pallas TPU kernel kernels/flash_attention.py
// (flash_attention -> pallas_call at :126, _kernel at :30). It computes the
// same function, not the same blocks: the TPU walks key tiles as the
// sequential innermost grid axis with (m, l, acc) in VMEM scratch; here a
// block takes (batch*head, query tile) work items and loops over each one's
// key tiles itself, with (m, l, acc) in registers. The loop starts at the window's first
// tile and stops at the causal diagonal, so fully masked tiles cost nothing.
// The kv head is read as h / rep (GQA) and never repeated in memory. Tensors
// are addressed through (batch, head, seq) strides with a contiguous last dim,
// so the model's (B, S, H, D) projections are read in place. The ragged edge
// needs no padded copy: neither Sq nor Sk has to divide a tile (the TPU kernel
// asserts that they do, flash_attention.py:113).
//
// Bound on the H100: at the slice's prefill shape (B=4, H=32, Hkv=8, S=500,
// D=128, causal) q, k, v and o once are 41 MB, 12.2 us at 3.35 TB/s, against
// 8.2 GFLOP of visible products, 8.3 us at 989 TFLOP/s. A work item has too
// little work to hide a load behind, so the design keeps copies in flight
// while the tensor cores work, across items too, and skips every masked
// element it can:
//
// bf16: a work item is 128 query rows of one (batch, head). One block per SM
// (persistent) walks the items, the query tiles with the most keys first;
// 288 threads: two consumer warpgroups of 64 rows each and one producer warp.
// The producer's first lane brings Q into one of two buffers and K and V
// tiles of 64 keys into a ring of kStages stages with TMA
// (cp.async.bulk.tensor, 4-D tensor maps over the operands' (batch, head,
// seq, dim) strides, 128-byte swizzle, two 64-column boxes per 128-wide row),
// with a full and an empty mbarrier per stage and per Q buffer, so the next
// tiles, and the next item's Q, land while the current tile is multiplied.
// TMA zero-fills rows past Sq / Sk and columns past D: D = 16, 24 and 32 are
// padded to 64 columns in shared memory and D = 80 to 128 (two boxes, the
// second 16 wide in the tensor; the TMA store clips the output to Dv). Q K^T
// runs over the true D rounded up to a k-step of 16 (one step at 16, two at 24,
// whose second reads 8 zero columns); P V multiplies the padded width: at
// D = 80 128 columns, 1.6x the true D's products there (1.3x of the kernel's
// products), at Dv = 16 64 columns, 4x (2.5x of the kernel's at (16, 16),
// 2.4x at (24, 16)). The smoke configs' pairs (16, 16) and (24, 16) (every
// smoke config's head dim, and DeepSeek's smoke MLA: q/k 16 + 8 rope, v 16)
// are bound by launch latency, not by the card: at minitron-8b smoke's
// prefill (B=2, H=4, Hkv=2, S=40, (16, 16), causal) q, k, v and o are 30.7
// KB, 9.2 ns at 3.35 TB/s, against 0.42 MFLOP of visible products. Q and K may have another head dim
// than V and O (DeepSeek's MLA: Dqk 192 = 128 + 64 rope columns, Dv 128): Q
// and K tiles then hold three boxes, V and O two, and the ring is 3 stages
// deep (2 x 48 KB of Q, 40 KB a stage: 216 KB). S = Q K^T is wgmma m64n64k16 with both operands
// in shared memory; P is rounded to bf16 once and fed from registers as the A
// operand of O += P V, wgmma m64nDk16 with V read through the descriptor's
// transpose (MN-major) mode. A tile's P V is issued after the next tile's
// Q K^T and runs while that tile's softmax does; the issue sequence has no
// branch and barriers are arrived on by predicated instructions, since ptxas
// serializes wgmma across divergent code. Only tiles that cross the causal
// diagonal, the window's first key or Sk are masked. Rounding points: fp32
// scores, the scale folded into exp2 as log2(e)/sqrt(Dqk) with the true Dqk
// (24 at the smoke MLA, not its 64 padded columns; one FMA before the
// exponential), fp32 m, l and acc, one division by l at the end; a row that
// sees no key gives 0. The output goes out through the item's Q buffer by a
// TMA store, so a warpgroup starts its next item without waiting for it.
//
// fp32: multiplied in fp32 on the CUDA cores (no TF32), one warp per query
// row, 8 rows per block, key tiles of 32 staged in static shared memory, so
// that the fp32 tests hold the reference's 2e-5; V's tile follows Dv, which
// keeps Dqk 192 / Dv 128 at 47.2 KB, under the 48 KB static limit. A lane
// holds Dv / 32 output dims rounded up; where 32 does not divide Dv (80, 16)
// the lanes past Dv hold none.
#include "common.cuh"
#include "hopper.cuh"

namespace kern {
namespace {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements: (batch, head, seq); the last dim is contiguous
  long long qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s, os_b, os_h, os_s;
  int B, H, rep, Sq, Sk, causal, window;  // window <= 0: no window
  float scale_log2;                       // log2(e) / sqrt(Dqk)
};

// Keys [lo, hi) that query rows [q0, q0 + rows) can see; lo rounded down to bk.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- bf16, TMA + wgmma

constexpr int kBQ = 128;               // query rows per work item
constexpr int kBK = 64;                // keys per tile
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box, 8 KB
constexpr int kFlashThreads = 288;     // two consumer warpgroups + one producer warp
constexpr int kProducer = 256;         // thread index of the producer's first lane
constexpr int kConsumerWarps = 8;      // arrivals that free a stage

// Q and K have head dim DQ, V and O head dim DV (equal but for MLA).
template <int DQ, int DV>
struct FlashTiles {
  static constexpr int kDPQ = (DQ + 63) / 64 * 64;  // Q, K columns in shared memory: whole 64-column boxes
  static constexpr int kDPV = (DV + 63) / 64 * 64;  // V, O columns
  static constexpr int kNBQ = kDPQ / 64;            // 64-column boxes per Q or K row
  static constexpr int kNBV = kDPV / 64;            // per V or O row
  static_assert(kDPV <= kDPQ, "O is staged in its item's Q buffer");
  static constexpr int kStages = kDPQ == 192 ? 3 : kDPQ == 128 ? 5 : 8;  // K/V ring depth
  static constexpr int kKTile = kNBQ * kBox;        // one K tile, or 64 query rows
  static constexpr int kVTile = kNBV * kBox;        // one V tile
  static constexpr int kQBytes = 2 * kKTile;        // one work item's 128 query rows
  static constexpr int kBarOffset = 2 * kQBytes + kStages * (kKTile + kVTile);
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 4);  // + alignment slack
  static_assert(kSmem <= 232448, "over the 227 KB a block may opt in to");
};

// A work item is (query tile, batch * head); items are numbered so that the
// query tiles with the most keys (causal) come first.
struct Item {
  int b, h, q0, lo, nt;
};

__device__ __forceinline__ Item item_at(const FlashArgs& a, int idx, int nqt, int BH) {
  Item it;
  const int qt = nqt - 1 - idx / BH, bh = idx % BH;
  it.b = bh / a.H;
  it.h = bh % a.H;
  it.q0 = qt * kBQ;
  int hi;
  key_range(a, it.q0, kBQ, kBK, it.lo, hi);
  it.nt = hi > it.lo ? (hi - it.lo + kBK - 1) / kBK : 0;
  return it;
}

// O += P V for one tile: V (keys x dims) is MN-major; 16 keys are 2048
// bytes, and the second 64-column box (D = 80 and 128) lies kBox further.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2], const uint32_t (&pa)[4][4], const unsigned char* v_t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t vd = desc_sw128(v_t + kk * 2048, kBox, 1024);
    if constexpr (DP == 128) {
      wgmma_m64n128k16_rs(acc, pa[kk], vd);
    } else {
      wgmma_m64n64k16_rs(acc, pa[kk], vd);
    }
  }
}

// Persistent: one block per SM walks the work items i, i + gridDim.x, ...
// The producer's ring and Q buffers run on across items, so the next item's
// Q and first tiles land while the consumers finish the current one.
template <int DQ, int DV>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_wgmma_kernel(const FlashArgs a, const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mo) {
  using C = FlashTiles<DQ, DV>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles start on 1024-byte boundaries.
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [buffer][half][box]
  unsigned char* k_s = q_s + 2 * C::kQBytes;                                      // [stage][box]
  unsigned char* v_s = k_s + C::kStages * C::kKTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(q_s + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* qfull = empty + C::kStages;
  uint64_t* qempty = qfull + 2;

  const int nqt = (a.Sq + kBQ - 1) / kBQ, BH = a.B * a.H, items = nqt * BH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 2);  // one thread of each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Roles by warpgroup, proven warp-uniform so that ptxas does not serialize wgmma.
  const int wg = warp_uniform(threadIdx.x / 128);
  if (wg == 2) {
    if (threadIdx.x == kProducer) {
      int ring = 0;  // tiles issued so far
      for (int idx = blockIdx.x, n = 0; idx < items; idx += gridDim.x, ++n) {
        const Item it = item_at(a, idx, nqt, BH);
        const int qb = n & 1, hk = it.h / a.rep;
        if (n >= 2) mbar_wait(&qempty[qb], ((n >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&qfull[qb], C::kQBytes);
        for (int half = 0; half < 2; ++half)
          for (int cb = 0; cb < C::kNBQ; ++cb)
            tma_load_4d(q_s + qb * C::kQBytes + (half * C::kNBQ + cb) * kBox, &mq, &qfull[qb], 64 * cb,
                        it.q0 + 64 * half, it.h, it.b);
        for (int i = 0; i < it.nt; ++i, ++ring) {
          const int st = ring % C::kStages, k0 = it.lo + i * kBK;
          if (ring >= C::kStages) mbar_wait(&empty[st], (ring / C::kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[st], C::kKTile + C::kVTile);
          for (int cb = 0; cb < C::kNBQ; ++cb)
            tma_load_4d(k_s + st * C::kKTile + cb * kBox, &mk, &full[st], 64 * cb, k0, hk, it.b);
          for (int cb = 0; cb < C::kNBV; ++cb)
            tma_load_4d(v_s + st * C::kVTile + cb * kBox, &mv, &full[st], 64 * cb, k0, hk, it.b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup `wg` owns query rows [wq0, wq0 + 64) of an item; this
  // thread rows r0 and r1 of the wgmma accumulator layout.
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int ring = 0;  // tiles consumed so far
  for (int idx = blockIdx.x, n = 0; idx < items; idx += gridDim.x, ++n) {
    const Item it = item_at(a, idx, nqt, BH);
    const int qb = n & 1;
    const int wq0 = it.q0 + 64 * wg, r0 = wq0 + 16 * warp + g, r1 = r0 + 8;
    int wlo, whi;
    key_range(a, wq0, 64, 1, wlo, whi);
    const unsigned char* q_w = q_s + qb * C::kQBytes + wg * C::kKTile;

    float acc[C::kDPV / 2];
#pragma unroll
    for (int i = 0; i < C::kDPV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[4][4];  // P of the last tile, until its P V is issued (0 before the first)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    int pending = -1;   // that tile's stage, or -1

    mbar_wait(&qfull[qb], (n >> 1) & 1);
    for (int i = 0; i < it.nt; ++i, ++ring) {
      const int st = ring % C::kStages, k0 = it.lo + i * kBK;
      mbar_wait(&full[st], (ring / C::kStages) & 1);
      if (!(wq0 < a.Sq && k0 < whi && k0 + kBK > wlo)) {  // every key of the tile is masked here
        mbar_arrive_if(&empty[st], lane == 0);
        continue;
      }

      // S = Q K^T (64 rows x 64 keys), both operands K-major in shared memory,
      // over the true Dqk rounded up to 16 (at D = 80 the fifth k-step reads
      // the second box's first 16 columns; at 192, 12 k-steps over three
      // boxes; at 24, two, the second over 8 columns and 8 of TMA's zeros); then the
      // last tile's P V, which runs while this tile's softmax does.
      // The issue sequence has no branch (ptxas serializes wgmma otherwise):
      // an item's first tile adds P = 0 times its own V.
      float s[32];
      fence_regs(s);
      wgmma_fence();
      const unsigned char* k_t = k_s + st * C::kKTile;
#pragma unroll
      for (int kk = 0; kk < (DQ + 15) / 16; ++kk) {
        const int off = (kk / 4) * kBox + (kk % 4) * 32;  // 16 columns = 32 bytes into a 128-byte row
        wgmma_m64n64k16_ss(s, desc_sw128(q_w + off, 16, 1024), desc_sw128(k_t + off, 16, 1024), kk);
      }
      wgmma_commit();
      issue_pv<C::kDPV>(acc, pa, v_s + (pending >= 0 ? pending : st) * C::kVTile);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // Scale, and mask only a tile that crosses the diagonal, the window's
      // first key or Sk. s[4j + e]: row e < 2 ? r0 : r1, key k0 + 8j + 2t + (e & 1).
      const bool inside = k0 + kBK <= a.Sk && (!a.causal || k0 + kBK - 1 <= wq0) &&
                          (a.window <= 0 || k0 >= wq0 + 64 - a.window);
      float mx[2] = {kNegInf, kNegInf};
      if (inside) {
#pragma unroll
        for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          s[e] = visible(a, (e & 2) ? r1 : r0, kpos) ? s[e] : kNegInf;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        }
      }

      // Online softmax (a row's values are spread over the 4 threads of a
      // quad), m in the log2 domain: p = 2^(s * log2(e)/sqrt(Dqk) - m), one FMA
      // before the exponential. A masked score is kNegInf, so its p is 0; a
      // row that has seen no visible key yet keeps m = kNegInf and takes 0 as
      // its reference.
      float alpha[2], ref[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * a.scale_log2);
        alpha[r] = fast_exp2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
        ref[r] = mn == kNegInf ? 0.f : mn;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = fast_exp2(fmaf(s[e], a.scale_log2, -ref[(e >> 1) & 1]));
        l[(e >> 1) & 1] += s[e];
      }
      fence_regs(s);  // the exponentials are done before the wait below
      fence_regs(l);

      wgmma_wait<0>();  // the last tile's P V is done: its stage is free
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive_if(&empty[pending >= 0 ? pending : st], lane == 0 && pending >= 0);
#pragma unroll
      for (int i = 0; i < C::kDPV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // P as the A operand of wgmma: keys 16kk..16kk+15 are accumulator
      // column blocks 2kk and 2kk+1, the same fragment layout.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      pending = st;
    }
    if (pending >= 0) {
      fence_regs(acc);
      wgmma_fence();
      issue_pv<C::kDPV>(acc, pa, v_s + pending * C::kVTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive_if(&empty[pending], lane == 0);
    }

    // Epilogue: O, normalised and rounded to bf16, goes into this warpgroup's
    // half of the item's Q buffer (every product that read it is done), in
    // the swizzled layout of the output's tensor map; one thread stores it
    // with TMA, which clips rows past Sq and columns past Dv, and frees the Q
    // buffer once the store has read it. The warpgroup goes on at once.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // a row with no visible key gives 0
    }
    unsigned char* o_w = q_s + qb * C::kQBytes + wg * C::kKTile;
    const int row0 = 16 * warp + g;
#pragma unroll
    for (int j = 0; j < C::kDPV / 8; ++j) {
      unsigned char* box = o_w + (j / 8) * kBox;
      const int col = (8 * j) % 64 + 2 * t;
      *reinterpret_cast<uint32_t*>(box + sw128_offset(row0, col)) =
          pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(box + sw128_offset(row0 + 8, col)) =
          pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      if (wq0 < a.Sq) {
        for (int cb = 0; cb < C::kNBV; ++cb) tma_store_4d(&mo, o_w + cb * kBox, 64 * cb, wq0, it.h, it.b);
        bulk_commit();
        bulk_wait_read();
      }
      mbar_arrive(&qempty[qb]);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the stores are done
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime (no -lcuda).
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map over (dim, seq, head, batch) with the given element
// strides, boxes of 64 x 64 (dim x seq), 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int D, int S, int heads, int B, long long s_s,
              long long s_h, long long s_b) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_s) * 2, static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch_bf16(const FlashArgs& a, int Hkv, cudaStream_t stream) {
  using C = FlashTiles<DQ, DV>;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, a.q, DQ, a.Sq, a.H, a.B, a.qs_s, a.qs_h, a.qs_b) ||
      !make_map(&mk, a.k, DQ, a.Sk, Hkv, a.B, a.ks_s, a.ks_h, a.ks_b) ||
      !make_map(&mv, a.v, DV, a.Sk, Hkv, a.B, a.vs_s, a.vs_h, a.vs_b) ||
      !make_map(&mo, a.o, DV, a.Sq, a.H, a.B, a.os_s, a.os_h, a.os_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Once per device: the opt-in to kSmem bytes of shared memory, the SM count.
  static int sms_of[kMaxDevices] = {};
  cudaError_t err;
  const int dev = device_slot(err);
  if (dev < 0) return static_cast<int>(err);
  if (sms_of[dev] == 0) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    sms_of[dev] = n;
  }
  const int sms = sms_of[dev];
  const int items = (a.Sq + kBQ - 1) / kBQ * a.B * a.H;
  flash_wgmma_kernel<DQ, DV><<<items < sms ? items : sms, kFlashThreads, C::kSmem, stream>>>(a, mq, mk, mv, mo);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- fp32, CUDA cores

template <int DQ, int DV>
__global__ void __launch_bounds__(256) flash_f32_kernel(FlashArgs a) {
  // DL output dims per lane; where 32 does not divide DV (80, 16) the last slot is guarded.
  constexpr int ROWS = 8, BK = 32, DL = (DV + 31) / 32;
  __shared__ float q_s[ROWS][DQ];
  __shared__ float k_s[BK][DQ + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float v_s[BK][DV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, hk = h / a.rep;
  const int q0 = blockIdx.x * ROWS, row = q0 + warp;
  const float* Q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* K = static_cast<const float*>(a.k) + b * a.ks_b + hk * a.ks_h;
  const float* V = static_cast<const float*>(a.v) + b * a.vs_b + hk * a.vs_h;
  float* O = static_cast<float*>(a.o) + b * a.os_b + h * a.os_h;

  for (int c = lane; c < DQ; c += 32) q_s[warp][c] = row < a.Sq ? Q[row * a.qs_s + c] * a.scale_log2 : 0.f;
  float m = kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  int lo, hi;
  key_range(a, q0, ROWS, BK, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * DQ; i += blockDim.x) {
      const int r = i / DQ, c = i % DQ;
      k_s[r][c] = k0 + r < a.Sk ? K[(k0 + r) * a.ks_s + c] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += blockDim.x) {
      const int r = i / DV, c = i % DV;
      v_s[r][c] = k0 + r < a.Sk ? V[(k0 + r) * a.vs_s + c] : 0.f;
    }
    __syncthreads();
    const int kpos = k0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < DQ; ++c) s = fmaf(q_s[warp][c], k_s[lane][c], s);
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
      for (int i = 0; i < DL; ++i)
        if (DV % 32 == 0 || lane + 32 * i < DV) acc[i] = fmaf(pj, v_s[j][lane + 32 * i], acc[i]);
    }
  }
  if (row < a.Sq) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      if (DV % 32 == 0 || lane + 32 * i < DV) O[row * a.os_s + lane + 32 * i] = acc[i] * inv;
  }
}

template <int DQ, int DV>
int launch(const FlashArgs& a, int Hkv, int dtype, cudaStream_t stream) {
  if (dtype == kBFloat16) return launch_bf16<DQ, DV>(a, Hkv, stream);
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.Sq + 7) / 8, a.B * a.H);
  flash_f32_kernel<DQ, DV><<<grid, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace kern

// q: (B, H, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv); o: (B, H, Sq, Dv),
// all addressed through strides[12] = (q, k, v, o) x (batch, head, seq) in
// elements. (D, Dv): (16, 16), (24, 16), (32, 32), (64, 64), (80, 80), (128, 128),
// (192, 128).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     const long long* strides, int B, int H, int Hkv, int Sq,
                                     int Sk, int D, int Dv, int causal, int window, int dtype,
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
  a.B = B;
  a.H = H;
  a.rep = H / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = kern::kLog2e / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_PAIR(DQ, DV) \
  if (D == DQ && Dv == DV) return kern::launch<DQ, DV>(a, Hkv, dtype, st);
  REPRO_FLASH_PAIR(16, 16) REPRO_FLASH_PAIR(24, 16) REPRO_FLASH_PAIR(32, 32) REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(80, 80) REPRO_FLASH_PAIR(128, 128) REPRO_FLASH_PAIR(192, 128)
#undef REPRO_FLASH_PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
