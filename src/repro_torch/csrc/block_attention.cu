// banded_attention: sliding-window flash attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_attention.py::
// banded_attention (body _kernel).  q is (H, S, D), k and v are (H_kv, S, D)
// with H_kv dividing H: query head h reads kv head h / (H / H_kv), so
// grouped-query attention needs no copy of k and v over the group.  Query i
// attends key j iff |i - j| < window, and j <= i when causal.  Scores, their
// 1/sqrt(D) scale, the online softmax (running max m, denominator l) and the
// accumulator stay float32; the output acc / (l + 1e-30) is stored once, in
// q's type.  Masked scores are excluded exactly as in the Pallas body: they
// read -1e30 for the running max and contribute 0 to l and acc.
//
// What bounds it on the H100: at the LM's shapes (S = 32768, window 4096,
// D = 120, bf16) a head is 126 M (query, key) pairs, 480 FLOP each, on
// 31 MB of q, k, v and o: about 2,000 FLOP a byte, so operations bound it,
// and the bound is the bf16 tensor-core rate (989 TFLOP/s).
//
// Two designs; the wrapper (kernels/block_attention.py) picks one a call.
//
// tc::banded_attention_wgmma — bfloat16 with D % 8 == 0, the LM's path.
// Tensor cores, since only they reach the bound.  One block owns 128 query
// rows of one head: two consumer warpgroups of 64 rows and one producer
// warpgroup, whose registers go to the consumers (setmaxnreg: without it
// ptxas serializes the wgmma for want of registers).  The producer's first
// lane loads the q tile once and then every 64-key K/V tile of the band
// into a ring of 2-4 stages with TMA (3-D tensor maps over (D, S, heads),
// 64 x 64 boxes, 128-byte swizzle; boxes past S or past D read zeros,
// which pads D to a multiple of 64 for q k^T), each stage signalled by an
// mbarrier and released by the consumers' warps.  So a K/V tile is read
// once for 128 rows, and the kv head comes from the query head in the
// kernel.  Each consumer computes S = q k^T with wgmma (both operands
// K-major in shared memory) and O += p v with wgmma taking p from
// registers and v as an MN-major operand from shared memory; the p v of
// one tile runs on the tensor cores while the warpgroup does the next
// tile's online softmax in float32 on the accumulator registers (exp2 of
// scores prescaled by log2(e) / sqrt(D)).  p enters p v as two bf16 parts,
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products into the same
// float32 accumulator: p v then keeps about 16 bits of p, and the output
// keeps the one rounding of the FMA design (a single bf16 p would miss the
// per-element check against the float32 plain version).  That costs half
// again the tensor-core work that the bound counts.  Every tile of the
// block's band is computed by both warpgroups (a wgmma under a branch that
// ptxas cannot prove uniform is serialized); only tiles that cross the
// band's edge, the diagonal or S build the per-element mask.
//
// banded_attention_kernel — everything else: float32 (whose atol 1e-4
// tensor cores cannot meet without 3xTF32) and bfloat16 with D % 8 != 0.
// Plain float32 FMA loops, at best the 67 TFLOP/s of float32 outside the
// tensor cores.  The TPU kernel walks the band on a sequential third grid
// axis and keeps m, l and acc in VMEM across its steps, clamping
// out-of-range kv blocks to block 0 and masking them away.  Here one thread
// block owns one (head, 64-query tile) and a loop inside it walks the
// 64-key tiles that the band touches, each exactly once; tiles outside
// [0, S) are never visited.  The q tile and each k and v tile are staged in
// shared memory as float32 (rows padded to an odd stride, so that a warp
// reading one column of different rows hits different banks); P = softmax
// numerators of the tile goes through shared memory to the P @ V step.
// 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16 i
// (i < 4), score columns tx + 16 c (c < 4) and output columns tx + 16 j
// (j < NJ), so row maxima and sums reduce over the 16 lanes of one
// half-warp with shuffles.
//
// In both the mask is per element, so the tile size is the kernel's own:
// rows and keys past S are masked here, and the caller's block_q / block_kv
// do not reach it.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"


namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per kv tile
constexpr int TPB = 256;           // threads per block, a 16 x 16 grid
constexpr int RPT = BQ / 16;       // query rows per thread
constexpr int CPT = BK / 16;       // score columns per thread
constexpr int PLD = BK + 1;        // P row stride (odd: no bank conflicts)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared floats of one block: q and k tiles at row stride D + 1 (odd, as D
// is even), the v tile at stride 16 * NJ (columns past D zeroed), P.
__host__ __device__ inline int smem_floats(int d, int nj) {
  return (BQ + BK) * (d + 1) + BK * 16 * nj + BQ * PLD;
}

// Copy rows [row0, row0 + rows) of one head's (S, D) slab into shared
// memory as float32 at row stride ld; rows past S and columns past D read 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int rows, int S, int D,
                                      int ld) {
  for (int e = threadIdx.x; e < rows * ld; e += TPB) {
    const int r = e / ld, c = e - r * ld;
    const int g = row0 + r;
    dst[e] = (g < S && c < D) ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

template <int NJ, typename T>
__global__ void __launch_bounds__(TPB)
banded_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int S,
                        int D, int group, int window, int causal,
                        float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int vld = 16 * NJ;
  float* qs = smem;                 // BQ x ld
  float* ks = qs + BQ * ld;         // BK x ld
  float* vs = ks + BK * ld;         // BK x vld
  float* ps = vs + BK * vld;        // BQ x PLD

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * S * D;
  const size_t kv_head = (size_t)(blockIdx.y / group) * S * D;
  const T* qh = q + head;
  const T* kh = k + kv_head;
  const T* vh = v + kv_head;

  stage(qs, qh, q0, BQ, S, D, ld);

  // the kv tiles the band of rows [q0, q_last] touches, within [0, S)
  const int q_last = min(q0 + BQ, S) - 1;
  const int lo = max(0, q0 - window + 1);
  const int hi = causal ? q_last : min(S - 1, q_last + window - 1);

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = lo / BK; t <= hi / BK; ++t) {
    const int k0 = t * BK;
    __syncthreads();               // the previous tile's reads are done
    stage(ks, kh, k0, BK, S, D, ld);
    stage(vs, vh, k0, BK, S, D, vld);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 c
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[CPT];
      float row_max = NEG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = kp < S && qp - kp < window && kp - qp < window &&
                (!causal || kp <= qp);
        s[i][c] = ok[c] ? s[i][c] * scale : NEG;
        row_max = fmaxf(row_max, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        ps[(ty + 16 * i) * PLD + tx + 16 * c] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P @ V over this tile's keys
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[NJ];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * vld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* oh = o + head;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float inv = 1.f / (l[i] + 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) oh[(size_t)qp * D + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <int NJ, typename T>
int launch_nj(const T* q, const T* k, const T* v, T* o, int H, int group,
              int S, int D, int window, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(D, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attention_kernel<NJ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H);
  banded_attention_kernel<NJ, T><<<grid, TPB, smem, st>>>(
      q, k, v, o, S, D, group, window, causal, 1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int H,
           int H_kv, int S, int D, int window, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  T* O = static_cast<T*>(o);
  const int G = H / H_kv;
  // output columns per thread: the fewest instantiated NJ with 16 NJ >= D
  if (D <= 16) return launch_nj<1, T>(Q, K, V, O, H, G, S, D, window, causal, st);
  if (D <= 32) return launch_nj<2, T>(Q, K, V, O, H, G, S, D, window, causal, st);
  if (D <= 64) return launch_nj<4, T>(Q, K, V, O, H, G, S, D, window, causal, st);
  if (D <= 128) return launch_nj<8, T>(Q, K, V, O, H, G, S, D, window, causal, st);
  if (D <= 160) return launch_nj<10, T>(Q, K, V, O, H, G, S, D, window, causal, st);
  return launch_nj<16, T>(Q, K, V, O, H, G, S, D, window, causal, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core design (bfloat16, D % 8 == 0)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;              // query rows of one consumer warpgroup
constexpr int kConsumers = 2;          // consumer warpgroups a block
constexpr int kBQ = kRows * kConsumers;  // query rows a block
constexpr int kBK = 64;                // keys a K/V tile
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers' accumulators need (2 x 232 + 40 per SM sub-partition fits)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNeg = -1e30f;

// Ring stages for NB boxes of head width: the ring and the q tile must fit
// in the 227 KB a block may use.
template <int NB> struct Cfg {
  static constexpr int kStages = NB <= 2 ? 4 : NB == 3 ? 3 : 2;
  static constexpr int kQBytes = kConsumers * NB * kBoxBytes;
  static constexpr int kKVBytes = NB * kBoxBytes;           // K or V, one stage
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBars = 2 * kStages + 1;            // full, empty, q
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;  // + alignment
};

// The band of one block: key tiles [t_lo, t_hi] touched by rows
// [q0, q0 + kBQ) within [0, S); the same walk as the FMA design's.
struct Band {
  int t_lo, t_hi;
  __device__ Band(int q0, int S, int window, int causal) {
    const int q_last = min(q0 + kBQ, S) - 1;
    const int lo = max(0, q0 - window + 1);
    const int hi = causal ? q_last : min(S - 1, q_last + window - 1);
    t_lo = lo / kBK;
    t_hi = hi / kBK;
  }
};

// One block: query rows [q0, q0 + 128) of head blockIdx.y.  Warps 0-7 are
// two consumer warpgroups of 64 rows each; warps 8-11 are the producer
// warpgroup, which hands most of its registers to the consumers
// (setmaxnreg) and whose first lane brings the q tile and then every K/V
// tile of the band into the ring with TMA.  Per tile each consumer
// warpgroup issues S = q k^T (wgmma, q and k from shared memory) and then
// O += p_hi v + p_lo v of the previous tile (wgmma, p from registers, v
// from shared memory); while the tensor cores run p v, it does the online
// softmax of S in float32 on the accumulator registers; then it rescales
// O, splits the new p into bf16 p_hi + p_lo and releases the previous
// stage.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
banded_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int S, int D, int group,
                       int window, int causal, float scale_log2) {
  using C = Cfg<NB>;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kQBytes;
  const uint32_t v_s = k_s + ST * C::kKVBytes;
  // mbarriers: full[ST], empty[ST], q_full
  const uint32_t bar = base + C::kBarOff;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (ST + s); };
  const uint32_t q_full = bar + 16 * ST;

  const int head = blockIdx.y;
  const int kv_head = head / group;
  const int q0 = blockIdx.x * kBQ;
  const Band band(q0, S, window, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int nb = 0; nb < NB; ++nb)
          tma_load(q_s + (w * NB + nb) * kBoxBytes, &tm_q, q_full, nb * kBox,
                   q0 + w * kRows, head);
      for (int t = band.t_lo, i = 0; t <= band.t_hi; ++t, ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::kKVBytes);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(k_s + s * C::kKVBytes + nb * kBoxBytes, &tm_k, full(s),
                   nb * kBox, t * kBK, kv_head);
          tma_load(v_s + s * C::kKVBytes + nb * kBoxBytes, &tm_v, full(s),
                   nb * kBox, t * kBK, kv_head);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;                   // consumer warpgroup
  const int wq = warp % 4;                   // warp within it: rows 16 wq ..
  const int r_lo = q0 + wg * kRows;          // the warpgroup's rows
  const int r_hi = min(r_lo + kRows, S) - 1;
  // this thread's two rows (accumulator rows lane / 4 and lane / 4 + 8)
  const int row0 = r_lo + 16 * wq + lane / 4;
  const int col0 = 2 * (lane % 4);           // first of its key / column pairs

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  mbar_wait(q_full, 0);
  const uint32_t q_wg = q_s + wg * NB * kBoxBytes;

  // p of the previous tile, the A operand of its p v: 4 k-steps of 16 keys,
  // each split into bf16 hi and lo parts
  uint32_t p_hi[4][4], p_lo[4][4];
  int prev_s = 0;                            // the previous tile's stage (its v)
  for (int t = band.t_lo, i = 0; t <= band.t_hi; ++t, ++i) {
    const int s = i % ST;
    const int k0 = t * kBK;
    mbar_wait(full(s), (i / ST) & 1);
    // does the band give this warpgroup's rows every key of the tile?
    // (uniform over the warpgroup).  A tile that gives them none is
    // computed all the same, fully masked (p = 0), so that no wgmma sits
    // in a branch: ptxas serializes wgmma on a path it cannot prove uniform.
    const bool all = k0 + kBK - 1 < S &&
                     k0 + kBK - 1 <= (causal ? r_lo : r_lo + window - 1) &&
                     k0 >= r_hi - window + 1;

    // S = q k^T of this tile, then O += p v of the previous one: the
    // softmax below runs while the tensor cores do p v
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < 4 * NB; ++kq) {     // 16 columns of D at a time
      const uint32_t off = (kq / 4) * kBoxBytes + (kq % 4) * 32;
      mma_ss(sc, desc(q_wg + off, 16), desc(k_s + s * C::kKVBytes + off, 16),
             kq > 0);
    }
    wg_commit();
    if (i > 0) mma_split<NB>(acc, p_hi, p_lo, v_s + prev_s * C::kKVBytes);
    wg_commit();
    wg_wait<1>();                            // S is in
    fence_regs(sc);

    // online softmax on the accumulator: sc[4 c + 2 h + e] is row
    // row0 + 8 h, key k0 + 8 c + col0 + e.  m is kept prescaled by
    // log2(e) / sqrt(D), so p = 2^(s scale - m) is one FMA and one ex2; a
    // masked score reads -inf, which leaves m (never below -1e30) as it is
    // and gives p = 0.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = row0 + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * c + 2 * h + e];
          if (!all) {
            const int kp = k0 + 8 * c + col0 + e;
            const bool ok = kp < S && qp - kp < window && kp - qp < window &&
                            (!causal || kp <= qp);
            x = ok ? x : -INFINITY;
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      alpha[h] = ex2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * c + 2 * h + e];
          x = ex2(fmaf(x, scale_log2, -m_new));
          sum += x;
        }
      l[h] = alpha[h] * l[h] + sum;         // this thread's columns; summed at the end
      m[h] = m_new;
    }

    wg_wait<0>();                            // the previous p v is in
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    if (i > 0 && lane == 0) mbar_arrive(empty(prev_s));   // its k and v are read
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[nb][4 * c + 0] *= alpha[0];
        acc[nb][4 * c + 1] *= alpha[0];
        acc[nb][4 * c + 2] *= alpha[1];
        acc[nb][4 * c + 3] *= alpha[1];
      }
    split_bf16(sc, p_hi, p_lo);
    prev_s = s;
  }
  {                                          // the last tile's p v
    wg_fence();
    mma_split<NB>(acc, p_hi, p_lo, v_s + prev_s * C::kKVBytes);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
  }

  // acc / (l + 1e-30), rounded once to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt + 1e-30f);
    const int qp = row0 + 8 * h;
    if (qp >= S) continue;
    __nv_bfloat16* orow = o + ((size_t)head * S + qp) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = nb * kBox + 8 * c + col0;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[nb][4 * c + 2 * h] * inv, acc[nb][4 * c + 2 * h + 1] * inv);
      }
  }
}

template <int NB>
int launch_nb(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
              void* o, int H, int group, int S, int D, int window, int causal,
              cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(banded_attention_wgmma<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<NB>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H);
  banded_attention_wgmma<NB><<<grid, kThreads, Cfg<NB>::kSmem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, D, group, window, causal,
      1.4426950408889634f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int H, int H_kv,
           int S, int D, int window, int causal, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, H, S, D) || !make_map(&mk, k, H_kv, S, D) ||
      !make_map(&mv, v, H_kv, S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / H_kv;
  // boxes of 64 columns that cover D: q k^T runs over the zero-padded width
  if (D <= 64) return launch_nb<1>(mq, mk, mv, o, H, G, S, D, window, causal, st);
  if (D <= 128) return launch_nb<2>(mq, mk, mv, o, H, G, S, D, window, causal, st);
  if (D <= 192) return launch_nb<3>(mq, mk, mv, o, H, G, S, D, window, causal, st);
  return launch_nb<4>(mq, mk, mv, o, H, G, S, D, window, causal, st);
}

}  // namespace tc

// C entry points, loaded with ctypes.  q, o are contiguous (H, S, D) and
// k, v contiguous (H_kv, S, D) device arrays of one type, H_kv dividing H;
// 1 <= H <= 65535, S >= 1, D even and <= 256, 1 <= window <= S.  The
// wgmma entry also needs D % 8 == 0 and 16-byte-aligned bases.  The Python
// wrapper (kernels/block_attention.py) checks all of that and picks the
// entry; this side only launches.  Returns cudaGetLastError() (or the
// error of the call that set the kernel up).
extern "C" int banded_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, int H, int H_kv,
                                    int S, int D, int window, int causal,
                                    void* stream) {
  return launch<float>(q, k, v, o, H, H_kv, S, D, window, causal, stream);
}

extern "C" int banded_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, int H, int H_kv,
                                     int S, int D, int window, int causal,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, H, H_kv, S, D, window, causal,
                               stream);
}

extern "C" int banded_attention_wgmma_bf16(const void* q, const void* k,
                                           const void* v, void* o, int H,
                                           int H_kv, int S, int D, int window,
                                           int causal, void* stream) {
  return tc::launch(q, k, v, o, H, H_kv, S, D, window, causal, stream);
}
