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
// Two grids, one after the other on the caller's stream:
//
// (a) attention_bwd_dq_kernel — one block per (query head, BT query rows).
//     It stages q and do, walks the band's key tiles once for the row
//     statistics (running max m, sum l and the sum of P dP, rescaled as l
//     is), writes lse = m + log l and delta to an (H, S) float32 scratch,
//     then walks the tiles again: P = exp(scale s - lse), dP, dS,
//     dq += dS k.
// (b) attention_bwd_dkv_kernel — one block per (kv head, BT keys).  It
//     stages k and v once, then walks the G query heads and, for each, the
//     query tiles whose band covers its keys, rebuilding P from the
//     scratch: dv += P^T do, dk += dS^T q.  Each output element is written
//     once, by one block: no atomics, so the result does not depend on the
//     order blocks run in.
//
// What bounds it on the H100: five products of the band (q k^T, do v^T,
// dS k, P^T do, dS^T q), 2 D FLOP a (query, key) pair each; at the LM's
// training shape (S = 8192, window 4096, D = 120, 32 heads, bf16) that is
// 0.97 TFLOP on 0.1 GB of q, k, v, do and the gradients, so operations
// bound it, at the bf16 tensor-core rate.  This design is the simple one:
// float32 FMA on tiles in shared memory (at best the 67 TFLOP/s of float32
// outside the tensor cores), and it computes q k^T and do v^T once more in
// (a), nine products where five are needed.  Tiles are staged as float32
// at an odd row stride (D + 1), so a warp reading one column of 16 rows
// hits 16 banks.  256 threads as a 16 x 16 grid: thread (ty, tx) owns tile
// rows ty + 16 i, tile columns tx + 16 c and output columns tx + 16 j, so
// row reductions are shuffles inside a half-warp.  BT is 64 for D <= 128
// and 32 above, which keeps the six tiles of (b) under the 227 KB of
// shared memory a block may have.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// C entry points, loaded with ctypes.  q, do, dq are contiguous
// (H, S, D) and k, v, dk, dv contiguous (H_kv, S, D) device arrays of one
// type, H_kv dividing H; lse and delta are (H, S) float32 scratch.
// 1 <= H <= 65535, S >= 1, D even and <= 256, 1 <= window <= S.  The
// Python wrapper (kernels/block_attention_bwd.py) checks all of that; this
// side only launches.  Returns cudaGetLastError() (or the error of the call
// that set a kernel up).
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
