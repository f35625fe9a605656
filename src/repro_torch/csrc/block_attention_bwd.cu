// banded_attention backward: the gradient of sliding-window attention, for
// Hopper (sm_90a).
//
// The gradient of src/repro/kernels/block_attention.py::banded_attention
// (the forward this package runs as csrc/block_attention.cu).  The JAX
// package has no Pallas backward: it trains through XLA's autodiff of
// src/repro/models/layers.py::windowed_attention.  This kernel computes that
// gradient for the port.  Given q (H, S, D), k, v (H_kv, S, D) with H_kv
// dividing H (query head h reads kv head h / (H / H_kv)) and the output's
// gradient do (H, S, D), it writes
//
//   dq (H, S, D), dk and dv (H_kv, S, D), each kv head summed over its
//   G = H / H_kv query heads,
//
// with the forward's mask (query i sees key j iff |i - j| < window, and
// j <= i when causal), the 1/sqrt(D) scale applied here, float32 sums and
// outputs in q's type.  With P = softmax(scale q k^T) over the band,
// dP = do v^T and delta_i = sum_j P_ij dP_ij:
//
//   dv = P^T do,   dS = P * (dP - delta),   dq = scale dS k,
//   dk = scale dS^T q.
//
// delta_i equals rowsum(do_i * o_i) for the float32 o; it is summed here
// from P and dP rather than read from the forward's stored o, because a
// bfloat16 o moves it by up to 2**-8 of each term: on a row whose band
// holds a few keys (row 0: P = 1, dS = 0 exactly) that alone put dq and
// dk 1e-3 away from zero, outside the bf16 check of the smoke.
//
// In both designs (a) computes dq and the row statistics, one block per
// (query head, query rows), and writes lse and delta to a float32 scratch
// of H x Sp values each (Sp = S rounded up to 128); (b) computes dk and dv,
// one block per (kv head, keys), walking the G query heads of its group
// and rebuilding P from the scratch.  The grids run one after the other on
// the caller's stream.  Each output element is written once, by one block:
// no atomics, so the result does not depend on the order blocks run in.
//
// What bounds it on the H100: five products of the band (q k^T, do v^T,
// dS k, P^T do, dS^T q), 2 D FLOP a (query, key) pair each; at the LM's
// training shape (S = 8192, window 4096, D = 120, 32 heads, bf16) that is
// 0.97 TFLOP on 0.1 GB of q, k, v, do and the gradients, so operations
// bound it, at the bf16 tensor-core rate (989 TFLOP/s).
//
// Two designs; the wrapper (kernels/block_attention_bwd.py) picks one a
// call.
//
// tc::attention_bwd_dq_wgmma, then tc::attention_bwd_dkv_wgmma<NB, false>
// (dv) and <NB, true> (dk) — bfloat16 with D % 8 == 0 and D <= 128, the
// LM's training path (hd 120).  Tensor cores, since only they reach the
// bound, on the forward's machinery (hopper_tc.cuh): a producer warpgroup
// whose first lane streams 64-row tiles through a 4-stage mbarrier ring
// with TMA (64 x 64 boxes, 128-byte swizzle, zeros past S and past D), two
// consumer warpgroups of 64 rows each under setmaxnreg, m64n64k16 wgmma
// with float32 accumulators, exp2 of scores prescaled by log2(e)/sqrt(D).
//   (a) One block per (query head, 128 query rows).  The q and do rows are
//   loaded once; the K/V tiles of the band stream through the ring twice.
//   Pass 1: S = q k^T and dP = do v^T (both operands in shared memory,
//   K-major), the online max m and sum l, and sum(P dP) rescaled as l is;
//   lse' = m + log2 l and delta = sum(P dP) / l go to the scratch.  Pass 2:
//   S and dP again, P = 2^(S' - lse'), dS = P (dP - delta), dq += dS k with
//   dS from registers and k as an MN-major operand.
//   (b) Two grids of one kernel, one block per (kv head, 128 keys), so
//   that each q/do tile loaded serves 128 keys.  The k and v rows are
//   loaded once; the producer walks the G query heads and, for each, the
//   band's 64-query tiles of q and do with their 64 lse' and delta values
//   (a bulk copy).  The dv grid computes S^T = k q^T, P^T = 2^(S^T' - lse')
//   and dv += P^T do (do MN-major); the dk grid computes S^T, dP^T = v do^T,
//   dS^T = P^T (dP^T - delta) and dk += dS^T q (q MN-major).  Each keeps
//   its accumulator in registers over the walk and stores it once.
// Registers shaped the split.  ptxas compiles the consumers within the 232
// registers setmaxnreg gives them, but where the accumulators, fragments
// and products in flight at one time exceed what it will pipeline, it
// serializes every wgmma of the kernel (C7512: each waits for the one
// before), which costs more than any overlap gains.  dk and dv together
// are two 64 x D accumulators (128 registers a thread at D = 120) beside
// S^T and dP^T (64): one (b) grid for both was serialized and spilled, so
// they are two grids, which compute S^T twice.  For the same reason each
// tile's products in (a) and in the dk grid are waited for before the
// next tile's are issued; only the dv grid, whose registers allow it, runs
// the P^T do of one tile on the tensor cores while the warpgroup builds
// the next P^T, as the forward does.
// P and dS enter their products as two bf16 parts, hi = bf16(x) and
// lo = bf16(x - hi), two products into one float32 accumulator (a single
// bf16 rounding of P misses the per-element check against the float32
// plain version, as it did in the forward); q k^T and do v^T read bf16
// inputs, exact on the tensor cores.  So the design computes 13 m64n64k16
// products of a tile pair where the bound counts 5, over D padded to a
// multiple of 64.  Every tile of a block's band is computed by both
// warpgroups (ptxas serializes a wgmma under a branch it cannot prove
// uniform); only tiles that cross the band's edge, the diagonal or S build
// the per-element mask.
//
// attention_bwd_dq_kernel + attention_bwd_dkv_kernel — everything else:
// float32 (atol 1e-4, which the bf16 tensor cores cannot meet), bfloat16
// with D % 8 != 0 or D > 128.  The simple design: float32 FMA on tiles in
// shared memory (at best the 67 TFLOP/s of float32 outside the tensor
// cores), and it computes q k^T and do v^T once more in (a), nine products
// where five are needed.  (a) stages q and do, walks the band's key tiles
// once for the row statistics, writes lse = m + log l and delta, then
// walks them again: P = exp(scale s - lse), dP, dS, dq += dS k.  (b)
// stages k and v once, then walks the G query heads and, for each, the
// query tiles whose band covers its keys: dv += P^T do, dk += dS^T q.
// Tiles are staged as float32 at an odd row stride (D + 1), so a warp
// reading one column of 16 rows hits 16 banks.  256 threads as a 16 x 16
// grid: thread (ty, tx) owns tile rows ty + 16 i, tile columns tx + 16 c
// and output columns tx + 16 j, so row reductions are shuffles inside a
// half-warp.  BT is 64 for D <= 128 and 32 above, which keeps the six
// tiles of (b) under the 227 KB of shared memory a block may have.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int TPB = 256;           // threads per block, a 16 x 16 grid
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared floats of one block: four BT x (D + 1) tiles, two BT x (BT + 1)
// tiles and two rows of BT.  Reads of output columns past D run at most 14
// floats past a tile's end, into the next array.
__host__ __device__ inline int smem_floats(int bt, int d) {
  return 4 * bt * (d + 1) + 2 * bt * (bt + 1) + 2 * bt;
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

__device__ __forceinline__ bool in_band(int qp, int kp, int S, int window,
                                        int causal) {
  return qp < S && kp < S && qp - kp < window && kp - qp < window &&
         (!causal || kp <= qp);
}

// sum over the 16 lanes of a half-warp (every lane of the warp calls it)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// s = a b^T and dp = c e^T over D for the thread's tile rows ty + 16 i
// (of a and c) and columns tx + 16 c (of b and e), tiles at row stride ld
template <int R>
__device__ __forceinline__ void tile_products(
    const float* a, const float* c, const float* b, const float* e, int ld,
    int D, int ty, int tx, float (&s)[R][R], float (&dp)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[R], cv[R], bv[R], ev[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      av[i] = a[(ty + 16 * i) * ld + d];
      cv[i] = c[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bv[j] = b[(tx + 16 * j) * ld + d];
      ev[j] = e[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
      }
  }
}

template <int BT, int NJ, typename T>
__global__ void __launch_bounds__(TPB)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        T* __restrict__ dq,
                        float* __restrict__ lse_out,
                        float* __restrict__ delta_out, int S, int D,
                        int group, int window, int causal, float scale) {
  constexpr int R = BT / 16;       // tile rows (and columns) per thread
  constexpr int PLD = BT + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                // BT x ld
  float* dos = qs + BT * ld;       // BT x ld
  float* ks = dos + BT * ld;       // BT x ld
  float* vs = ks + BT * ld;        // BT x ld
  float* ps = vs + BT * ld;        // BT x PLD: dS of the tile

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const size_t head = (size_t)h * S * D;
  const size_t kv_head = (size_t)(h / group) * S * D;
  const T* kh = k + kv_head;
  const T* vh = v + kv_head;

  stage(qs, q + head, q0, BT, S, D, ld);
  stage(dos, dout + head, q0, BT, S, D, ld);
  __syncthreads();

  // the key tiles the band of rows [q0, q_last] touches, within [0, S)
  const int q_last = min(q0 + BT, S) - 1;
  const int lo = max(0, q0 - window + 1);
  const int hi = causal ? q_last : min(S - 1, q_last + window - 1);

  // pass 1: the row statistics over the band: m, l and delta
  float m[R], l[R], delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = delta[i] = 0.f;
  }
  for (int t = lo / BT; t <= hi / BT; ++t) {
    const int k0 = t * BT;
    __syncthreads();               // the previous tile's reads are done
    stage(ks, kh, k0, BT, S, D, ld);
    stage(vs, vh, k0, BT, S, D, ld);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_products<R>(qs, dos, ks, vs, ld, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[R];
      float row_max = NEG;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        ok[c] = in_band(qp, k0 + tx + 16 * c, S, window, causal);
        s[i][c] = ok[c] ? s[i][c] * scale : NEG;
        row_max = fmaxf(row_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      float row_sum = 0.f, row_pdp = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        row_sum += p;
        row_pdp = fmaf(p, dp[i][c], row_pdp);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      delta[i] = delta[i] * alpha + half_warp_sum(row_pdp);
      m[i] = m_new;
    }
  }

  float lse[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lse[i] = m[i] + logf(l[i]);
    delta[i] /= l[i];
    const int qp = q0 + ty + 16 * i;
    if (tx == 0 && qp < S) {
      lse_out[(size_t)h * S + qp] = lse[i];
      delta_out[(size_t)h * S + qp] = delta[i];
    }
  }

  // pass 2: dq = scale sum_j P_ij (dP_ij - delta_i) k_j
  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int t = lo / BT; t <= hi / BT; ++t) {
    const int k0 = t * BT;
    __syncthreads();
    stage(ks, kh, k0, BT, S, D, ld);
    stage(vs, vh, k0, BT, S, D, ld);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_products<R>(qs, dos, ks, vs, ld, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const bool ok = in_band(qp, k0 + tx + 16 * c, S, window, causal);
        const float p = ok ? expf(s[i][c] * scale - lse[i]) : 0.f;
        ps[(ty + 16 * i) * PLD + tx + 16 * c] = p * (dp[i][c] - delta[i]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[R], kv[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[kk * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dqh = dq + head;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dqh[(size_t)qp * D + c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <int BT, int NJ, typename T>
__global__ void __launch_bounds__(TPB)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S,
                         int D, int group, int window, int causal,
                         float scale) {
  constexpr int R = BT / 16;
  constexpr int PLD = BT + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;                // BT x ld, this block's keys
  float* vs = ks + BT * ld;        // BT x ld
  float* qs = vs + BT * ld;        // BT x ld, one query tile
  float* dos = qs + BT * ld;       // BT x ld
  float* pt = dos + BT * ld;       // BT x PLD: P^T of the tile
  float* dst = pt + BT * PLD;      // BT x PLD: dS^T of the tile
  float* lse_s = dst + BT * PLD;   // BT
  float* dl_s = lse_s + BT;        // BT

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const size_t kv_head = (size_t)hk * S * D;

  stage(ks, k + kv_head, k0, BT, S, D, ld);
  stage(vs, v + kv_head, k0, BT, S, D, ld);

  // the query tiles whose band covers keys [k0, k_last]
  const int k_last = min(k0 + BT, S) - 1;
  const int lo = causal ? k0 : max(0, k0 - window + 1);
  const int hi = min(S - 1, k_last + window - 1);

  float dka[R][NJ], dva[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t head = (size_t)h * S * D;
    for (int t = lo / BT; t <= hi / BT; ++t) {
      const int q0 = t * BT;
      __syncthreads();             // the previous tile's reads are done
      stage(qs, q + head, q0, BT, S, D, ld);
      stage(dos, dout + head, q0, BT, S, D, ld);
      if (threadIdx.x < BT) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < S ? lse[(size_t)h * S + qp] : 0.f;
        dl_s[threadIdx.x] = qp < S ? delta[(size_t)h * S + qp] : 0.f;
      }
      __syncthreads();
      // rows: this block's keys ty + 16 i; columns: queries tx + 16 c
      float s[R][R], dp[R][R];
      tile_products<R>(ks, vs, qs, dos, ld, D, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int col = tx + 16 * c;
          const bool ok = in_band(q0 + col, kp, S, window, causal);
          const float p = ok ? expf(s[i][c] * scale - lse_s[col]) : 0.f;
          pt[(ty + 16 * i) * PLD + col] = p;
          dst[(ty + 16 * i) * PLD + col] = p * (dp[i][c] - dl_s[col]);
        }
      }
      __syncthreads();
      for (int cc = 0; cc < BT; ++cc) {
        float pv[R], dsv[R], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = pt[(ty + 16 * i) * PLD + cc];
          dsv[i] = dst[(ty + 16 * i) * PLD + cc];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = dos[cc * ld + tx + 16 * j];
          qv[j] = qs[cc * ld + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dva[i][j] = fmaf(pv[i], dov[j], dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
          }
      }
    }
  }

  T* dkh = dk + kv_head;
  T* dvh = dv + kv_head;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dkh[(size_t)kp * D + c] = from_f32<T>(dka[i][j] * scale);
        dvh[(size_t)kp * D + c] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

template <int BT, int NJ, typename T>
int launch_nj(const T* q, const T* k, const T* v, const T* dout,
              T* dq, T* dk, T* dv, float* lse, float* delta, int H, int H_kv,
              int S, int D, int window, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(BT, D);
  const int group = H / H_kv;
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<BT, NJ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<BT, NJ, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + BT - 1) / BT;
  attention_bwd_dq_kernel<BT, NJ, T><<<dim3(tiles, H), TPB, smem, st>>>(
      q, k, v, dout, dq, lse, delta, S, D, group, window, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<BT, NJ, T><<<dim3(tiles, H_kv), TPB, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, D, group, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int H, int H_kv, int S, int D, int window,
           int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* DO = static_cast<const T*>(dout);
  T* DQ = static_cast<T*>(dq);
  T* DK = static_cast<T*>(dk);
  T* DV = static_cast<T*>(dv);
  float* L = static_cast<float*>(lse);
  float* DL = static_cast<float*>(delta);
#define BWD_LAUNCH(BT, NJ) \
  launch_nj<BT, NJ, T>(Q, K, V, DO, DQ, DK, DV, L, DL, H, H_kv, S, D, \
                       window, causal, st)
  // output columns per thread: the fewest instantiated NJ with 16 NJ >= D
  if (D <= 16) return BWD_LAUNCH(64, 1);
  if (D <= 32) return BWD_LAUNCH(64, 2);
  if (D <= 64) return BWD_LAUNCH(64, 4);
  if (D <= 128) return BWD_LAUNCH(64, 8);
  if (D <= 160) return BWD_LAUNCH(32, 10);
  return BWD_LAUNCH(32, 16);
#undef BWD_LAUNCH
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core design (bfloat16, D % 8 == 0, D <= 128)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;                 // rows of one consumer warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups a block
constexpr int kBT = kRows * kConsumers;   // query rows (a) or keys (b) a block
constexpr int kTile = 64;                 // keys (a) or queries (b) a ring tile
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
// registers a thread after setmaxnreg, as in the forward
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory for NB boxes of head width (NB <= 2): the block's own rows
// (q and do in (a), k and v in (b)), then the ring.  An (a) stage holds k
// and v; a (b) stage holds q, do and the tile's lse' and delta (padded to
// keep the boxes on the 1024-byte grid of the swizzle).
template <int NB> struct Cfg {
  static constexpr int kStages = 4;
  static constexpr int kRowBytes = kConsumers * NB * kBoxBytes;  // q, k, v or do
  static constexpr int kStageA = 2 * NB * kBoxBytes;
  static constexpr int kStatOff = 2 * NB * kBoxBytes;
  static constexpr int kStageB = kStatOff + 1024;
  static constexpr int kTxB = kStatOff + 2 * kTile * 4;         // bytes a (b) stage
  static constexpr int kBars = 2 * kStages + 1;                  // full, empty, rows
  static constexpr int kSmemA = 2 * kRowBytes + kStages * kStageA + 8 * kBars + 1024;
  static constexpr int kSmemB = 2 * kRowBytes + kStages * kStageB + 8 * kBars + 1024;
};

// d = A B^T over the padded head width: A and B two 64-row NB-box tiles in
// shared memory, both K-major (q k^T, do v^T, k q^T, v do^T)
template <int NB>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kq = 0; kq < 4 * NB; ++kq) {     // 16 columns of D at a time
    const uint32_t off = (kq / 4) * kBoxBytes + (kq % 4) * 32;
    mma_ss(d, desc(a + off, 16), desc(b + off, 16), kq > 0);
  }
}

// Does the band give every query of [q_lo, q_lo + 63] every key of
// [k_lo, k_lo + 63], all within S?  (Uniform over a warpgroup.)
__device__ __forceinline__ bool tile_in_band(int q_lo, int k_lo, int S, int window,
                                             int causal) {
  return q_lo + 63 < S && k_lo + 63 < S && q_lo + 63 - k_lo < window &&
         (causal ? k_lo + 63 <= q_lo : k_lo + 63 - q_lo < window);
}

__device__ __forceinline__ void init_barriers(uint32_t bar, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(bar + 8 * s, 1);                          // full: the producer's
    mbar_init(bar + 8 * (stages + s), 4 * kConsumers);  // empty: a consumer warp each
  }
  mbar_init(bar + 16 * stages, 1);                      // the block's own rows
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NB>
__device__ __forceinline__ void zero(float (&d)[NB][32]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[nb][i] = 0.f;
}

// Rows r0 and r0 + 8 of a 64 x (64 NB) accumulator, times `scale`, to the
// bf16 (rows, D) slab `out` (rows at or past S and columns past D skipped)
template <int NB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&d)[NB][32],
                                           int r0, int col0, int S, int D, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
    __nv_bfloat16* row = out + (size_t)r * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = nb * kBox + 8 * c + col0;
        if (col < D)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16(d[nb][4 * c + 2 * h] * scale, d[nb][4 * c + 2 * h + 1] * scale);
      }
  }
}

// (a): dq, lse' and delta of query rows [q0, q0 + 128) of head blockIdx.y.
// Warps 0-7 are two consumer warpgroups of 64 rows; warps 8-11 the
// producer.  The producer's first lane loads the q and do rows, then
// streams the band's K/V tiles into the ring twice, once a pass.
template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
                       float* __restrict__ delta_out, int S, int Sp, int D,
                       int group, int window, int causal, float scale_log2,
                       float scale) {
  using C = Cfg<NB>;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + C::kRowBytes;
  const uint32_t ring = do_s + C::kRowBytes;      // stage s: k, then v
  const uint32_t bar = ring + ST * C::kStageA;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (ST + s); };
  const uint32_t rows_full = bar + 16 * ST;

  const int head = blockIdx.y;
  const int kv_head = head / group;
  const int q0 = blockIdx.x * kBT;
  // the key tiles the band of rows [q0, q_last] touches, within [0, S)
  const int q_last = min(q0 + kBT, S) - 1;
  const int t_lo = max(0, q0 - window + 1) / kTile;
  const int n = (causal ? q_last : min(S - 1, q_last + window - 1)) / kTile - t_lo + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(bar, ST);
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(rows_full, 2 * C::kRowBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int nb = 0; nb < NB; ++nb) {
          const uint32_t off = (w * NB + nb) * kBoxBytes;
          tma_load(q_s + off, &tm_q, rows_full, nb * kBox, q0 + w * kRows, head);
          tma_load(do_s + off, &tm_do, rows_full, nb * kBox, q0 + w * kRows, head);
        }
      for (int i = 0; i < 2 * n; ++i) {           // the band, once a pass
        const int s = i % ST, t = t_lo + i % n;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(s), C::kStageA);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(ring + s * C::kStageA + nb * kBoxBytes, &tm_k, full(s),
                   nb * kBox, t * kTile, kv_head);
          tma_load(ring + s * C::kStageA + (NB + nb) * kBoxBytes, &tm_v, full(s),
                   nb * kBox, t * kTile, kv_head);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;                   // consumer warpgroup
  const int r_lo = q0 + wg * kRows;          // its rows
  // this thread's two rows (accumulator rows lane / 4 and lane / 4 + 8):
  // element 4 c + 2 h + e of an accumulator is row row0 + 8 h, column
  // 8 c + col0 + e
  const int row0 = r_lo + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * NB * kBoxBytes;
  const uint32_t do_wg = do_s + wg * NB * kBoxBytes;
  mbar_wait(rows_full, 0);

  // pass 1: m (prescaled by log2(e)/sqrt(D)), l and sum(P dP) of each row;
  // a masked score reads -inf, which leaves m (never below -1e30) as it is
  // and gives p = 0
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    const int s = i % ST, k0 = (t_lo + i) * kTile;
    const uint32_t k_t = ring + s * C::kStageA;
    mbar_wait(full(s), (i / ST) & 1);
    float sc[32], dp[32];
    wg_fence();
    mma_rows<NB>(sc, q_wg, k_t);
    mma_rows<NB>(dp, do_wg, k_t + NB * kBoxBytes);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(empty(s));    // this warp is done with k, v
    const bool all = tile_in_band(r_lo, k0, S, window, causal);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = row0 + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * c + 2 * h + e];
          if (!all) x = in_band(qp, k0 + 8 * c + col0 + e, S, window, causal) ? x : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      const float alpha = ex2(m[h] - m_new);
      float sum = 0.f, sum_pdp = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * c + 2 * h + e], scale_log2, -m_new));
          sum += p;
          sum_pdp = fmaf(p, dp[4 * c + 2 * h + e], sum_pdp);
        }
      l[h] = alpha * l[h] + sum;             // this thread's columns
      pdp[h] = alpha * pdp[h] + sum_pdp;
      m[h] = m_new;
    }
  }

  // lse' = m + log2 l and delta = sum(P dP) / l of each row, to the scratch
  // (rows past S get 0, so that (b) reads finite values there)
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]), pt = quad_sum(pdp[h]);
    const int qp = row0 + 8 * h;
    const bool ok = qp < S && lt > 0.f;
    lse[h] = ok ? m[h] + log2f(lt) : 0.f;
    dl[h] = ok ? pt / lt : 0.f;
    if (lane % 4 == 0 && qp < Sp) {
      lse_out[(size_t)head * Sp + qp] = lse[h];
      delta_out[(size_t)head * Sp + qp] = dl[h];
    }
  }

  // pass 2: dq += dS k, dS = P (dP - delta), P = 2^(S' - lse').  The
  // products of a tile are waited for before the next tile's are issued:
  // keeping dS k in flight beside the next S and dP needs more registers
  // than ptxas will pipeline wgmma with (it then serializes every wgmma of
  // the kernel, which costs more than the overlap gains)
  float acc[NB][32];
  zero<NB>(acc);
  for (int j = 0; j < n; ++j) {
    const int i = n + j;
    const int s = i % ST, k0 = (t_lo + j) * kTile;
    const uint32_t k_t = ring + s * C::kStageA;
    mbar_wait(full(s), (i / ST) & 1);
    float sc[32], dp[32];
    wg_fence();
    mma_rows<NB>(sc, q_wg, k_t);
    mma_rows<NB>(dp, do_wg, k_t + NB * kBoxBytes);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const bool all = tile_in_band(r_lo, k0, S, window, causal);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * c + 2 * h + e;
          float p = ex2(fmaf(sc[x], scale_log2, -lse[h]));
          if (!all)
            p = in_band(row0 + 8 * h, k0 + 8 * c + col0 + e, S, window, causal) ? p : 0.f;
          sc[x] = p * (dp[x] - dl[h]);
        }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    split_bf16(sc, ds_hi, ds_lo);
    wg_fence();
    mma_split<NB>(acc, ds_hi, ds_lo, k_t);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    if (lane == 0) mbar_arrive(empty(s));    // this warp is done with k, v
  }
  store_rows<NB>(dq + (size_t)head * S * D, acc, row0, col0, S, D, scale);
}

// (b): dv (DK false) or dk (DK true) of keys [k0, k0 + 128) of kv head
// blockIdx.y.  Warps 0-7 are two consumer warpgroups of 64 keys; warps
// 8-11 the producer, whose first lane loads the k and v rows, then
// streams, for each query head of the group, the 64-query tiles of q and
// do whose band covers the keys, with their lse' and delta.  dv and dk
// are two grids of one kernel, because the two 64 x D float32 accumulators
// of a warpgroup (128 registers a thread at D = 120) beside the tile's S^T
// and dP^T are more than ptxas pipelines wgmma with; apart, each grid
// keeps one accumulator, and the grids compute S^T = k q^T twice.
//   dv: S^T, P^T = 2^(S^T' - lse'), dv += P^T do; the P^T do of one tile
//   runs on the tensor cores while the warpgroup builds the next P^T (the
//   forward's pipeline).
//   dk: S^T and dP^T = v do^T, dS^T = P^T (dP^T - delta), dk += dS^T q.
template <int NB, bool DK>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ out, int S, int Sp, int D,
                        int group, int window, int causal, float scale_log2,
                        float scale) {
  using C = Cfg<NB>;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + C::kRowBytes;
  const uint32_t ring = v_s + C::kRowBytes;  // stage s: q, do, lse', delta
  const uint32_t bar = ring + ST * C::kStageB;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (ST + s); };
  const uint32_t rows_full = bar + 16 * ST;

  const int kv_head = blockIdx.y;
  const int k0 = blockIdx.x * kBT;
  // the query tiles whose band covers keys [k0, k_last], within [0, S)
  const int k_last = min(k0 + kBT, S) - 1;
  const int t_lo = (causal ? k0 : max(0, k0 - window + 1)) / kTile;
  const int n = min(S - 1, k_last + window - 1) / kTile - t_lo + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(bar, ST);
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(rows_full, 2 * C::kRowBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int nb = 0; nb < NB; ++nb) {
          const uint32_t off = (w * NB + nb) * kBoxBytes;
          tma_load(k_s + off, &tm_k, rows_full, nb * kBox, k0 + w * kRows, kv_head);
          tma_load(v_s + off, &tm_v, rows_full, nb * kBox, k0 + w * kRows, kv_head);
        }
      for (int i = 0; i < group * n; ++i) {
        const int s = i % ST, t = t_lo + i % n;
        const int head = kv_head * group + i / n;
        const uint32_t st = ring + s * C::kStageB;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(full(s), C::kTxB);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(st + nb * kBoxBytes, &tm_q, full(s), nb * kBox, t * kTile, head);
          tma_load(st + (NB + nb) * kBoxBytes, &tm_do, full(s), nb * kBox, t * kTile,
                   head);
        }
        const size_t at = (size_t)head * Sp + t * kTile;
        bulk_load(st + C::kStatOff, lse + at, kTile * 4, full(s));
        bulk_load(st + C::kStatOff + kTile * 4, delta + at, kTile * 4, full(s));
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int kr_lo = k0 + wg * kRows;         // the warpgroup's keys
  // this thread's two keys row0, row0 + 8 and its query columns 8 c + col0 + e
  const int row0 = kr_lo + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_wg = k_s + wg * NB * kBoxBytes;
  const uint32_t v_wg = v_s + wg * NB * kBoxBytes;

  float acc[NB][32];
  zero<NB>(acc);
  uint32_t hi[4][4], lo[4][4];               // dv: P^T of the previous tile
  int prev_s = 0;                            // dv: the previous tile's stage (its do)
  mbar_wait(rows_full, 0);

  for (int i = 0; i < group * n; ++i) {
    const int s = i % ST, q0 = (t_lo + i % n) * kTile;
    const uint32_t q_t = ring + s * C::kStageB;
    const uint32_t do_t = q_t + NB * kBoxBytes;
    const float* stat = reinterpret_cast<const float*>(smem_raw + (q_t - raw) + C::kStatOff);
    mbar_wait(full(s), (i / ST) & 1);
    float sc[32], dp[32];                    // S^T, dP^T: keys x queries
    wg_fence();
    mma_rows<NB>(sc, k_wg, q_t);
    if (DK) {
      mma_rows<NB>(dp, v_wg, do_t);
      wg_commit();
      wg_wait<0>();
      fence_regs(dp);
    } else {
      wg_commit();
      if (i > 0) mma_split<NB>(acc, hi, lo, ring + prev_s * C::kStageB + NB * kBoxBytes);
      wg_commit();
      wg_wait<1>();                          // S^T is in
    }
    fence_regs(sc);
    // P^T, and for dk dS^T in place over S^T
    const bool all = tile_in_band(q0, kr_lo, S, window, causal);
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + col0 + e;
        const float ls = stat[col], dlt = stat[kTile + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * c + 2 * h + e;
          float p = ex2(fmaf(sc[x], scale_log2, -ls));
          if (!all) p = in_band(q0 + col, row0 + 8 * h, S, window, causal) ? p : 0.f;
          sc[x] = DK ? p * (dp[x] - dlt) : p;
        }
      }
    if (DK) {                                // dk += dS^T q
      split_bf16(sc, hi, lo);
      wg_fence();
      mma_split<NB>(acc, hi, lo, q_t);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    } else {                                 // dv += P^T do, issued next tile
      wg_wait<0>();                          // the previous P^T do is in
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
      if (i > 0 && lane == 0) mbar_arrive(empty(prev_s));
      split_bf16(sc, hi, lo);
      prev_s = s;
    }
  }
  if (!DK) {                                 // the last tile's P^T do
    wg_fence();
    mma_split<NB>(acc, hi, lo, ring + prev_s * C::kStageB + NB * kBoxBytes);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
  }
  store_rows<NB>(out + (size_t)kv_head * S * D, acc, row0, col0, S, D,
                 DK ? scale : 1.f);
}

template <int NB>
int launch_nb(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
              const CUtensorMap& mdo, void* dq, void* dk, void* dv, float* lse,
              float* delta, int H, int H_kv, int S, int D, int window, int causal,
              cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_wgmma<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<NB>::kSmemA);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_bwd_dkv_wgmma<NB, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Cfg<NB>::kSmemB);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_bwd_dkv_wgmma<NB, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Cfg<NB>::kSmemB);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int G = H / H_kv;
  const int tiles = (S + kBT - 1) / kBT;
  const int Sp = tiles * kBT;
  const float scale = 1.0f / sqrtf((float)D);
  const float scale_log2 = 1.4426950408889634f * scale;
  attention_bwd_dq_wgmma<NB><<<dim3(tiles, H), kThreads, Cfg<NB>::kSmemA, st>>>(
      mq, mk, mv, mdo, static_cast<__nv_bfloat16*>(dq), lse, delta, S, Sp, D, G,
      window, causal, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_wgmma<NB, false><<<dim3(tiles, H_kv), kThreads, Cfg<NB>::kSmemB, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dv), S, Sp, D, G, window,
      causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_wgmma<NB, true><<<dim3(tiles, H_kv), kThreads, Cfg<NB>::kSmemB, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk), S, Sp, D, G, window,
      causal, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, void* lse, void* delta, int H, int H_kv, int S, int D,
           int window, int causal, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, H, S, D) || !make_map(&mk, k, H_kv, S, D) ||
      !make_map(&mv, v, H_kv, S, D) || !make_map(&mdo, dout, H, S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  float* DL = static_cast<float*>(delta);
  // boxes of 64 columns that cover D: the products run over the padded width
  if (D <= 64)
    return launch_nb<1>(mq, mk, mv, mdo, dq, dk, dv, L, DL, H, H_kv, S, D, window,
                        causal, st);
  return launch_nb<2>(mq, mk, mv, mdo, dq, dk, dv, L, DL, H, H_kv, S, D, window,
                      causal, st);
}

}  // namespace tc

// C entry points, loaded with ctypes.  q, do, dq are contiguous
// (H, S, D) and k, v, dk, dv contiguous (H_kv, S, D) device arrays of one
// type, H_kv dividing H; lse and delta are float32 scratch of H x Sp values
// each, Sp = S rounded up to 128.  1 <= H <= 65535, S >= 1, D even and
// <= 256, 1 <= window <= S.  The wgmma entry also needs bfloat16,
// D % 8 == 0, D <= 128 and 16-byte-aligned bases.  The Python wrapper
// (kernels/block_attention_bwd.py) checks all of that and picks the entry;
// this side only launches.  Returns cudaGetLastError() (or the error of the
// call that set a kernel up).
extern "C" int banded_attention_bwd_f32(const void* q, const void* k,
                                        const void* v, const void* dout, void* dq, void* dk,
                                        void* dv, void* lse, void* delta,
                                        int H, int H_kv, int S, int D,
                                        int window, int causal, void* stream) {
  return launch<float>(q, k, v, dout, dq, dk, dv, lse, delta, H, H_kv, S,
                       D, window, causal, stream);
}

extern "C" int banded_attention_bwd_bf16(const void* q, const void* k,
                                         const void* v, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta,
                                         int H, int H_kv, int S, int D,
                                         int window, int causal,
                                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse, delta, H,
                               H_kv, S, D, window, causal, stream);
}

extern "C" int banded_attention_bwd_wgmma_bf16(const void* q, const void* k,
                                               const void* v, const void* dout,
                                               void* dq, void* dk, void* dv, void* lse,
                                               void* delta, int H, int H_kv, int S,
                                               int D, int window, int causal,
                                               void* stream) {
  return tc::launch(q, k, v, dout, dq, dk, dv, lse, delta, H, H_kv, S, D, window,
                    causal, stream);
}
