// banded_attention: sliding-window flash attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_attention.py::
// banded_attention (body _kernel).  q, k, v are (H, S, D); query i attends
// key j iff |i - j| < window, and j <= i when causal.  Scores, their
// 1/sqrt(D) scale, the online softmax (running max m, denominator l) and the
// accumulator stay float32; the output acc / (l + 1e-30) is stored once, in
// q's type.  Masked scores are excluded exactly as in the Pallas body: they
// read -1e30 for the running max and contribute 0 to l and acc.
//
// What bounds it on the H100: at the LM's shapes (S = 32768, window 4096,
// D = 120, bf16) a head is 126 M (query, key) pairs, 480 FLOP each, on
// 31 MB of q, k, v and o: about 2,000 FLOP a byte, so operations bound it,
// and the bound is the bf16 tensor-core rate.  This first version does
// nothing about that: plain float32 FMA loops, no tensor cores, so it can
// reach at best the 67 TFLOP/s of float32 outside them.
//
// Design.  The TPU kernel walks the band on a sequential third grid axis
// and keeps m, l and acc in VMEM across its steps, clamping out-of-range kv
// blocks to block 0 and masking them away.  Here one thread block owns one
// (head, 64-query tile) and a loop inside it walks the 64-key tiles that the
// band touches, each exactly once; tiles outside [0, S) are never visited.
// The q tile and each k and v tile are staged in shared memory as float32
// (rows padded to an odd stride, so that a warp reading one column of
// different rows hits different banks); P = softmax numerators of the tile
// goes through shared memory to the P @ V step.  256 threads as a 16 x 16
// grid: thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 c (c < 4) and output columns tx + 16 j (j < NJ), so row maxima and
// sums reduce over the 16 lanes of one half-warp with shuffles.  The mask is
// per element, so the tile size is the kernel's own: rows and keys past S
// are masked here, and the caller's block_q / block_kv do not reach it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
                        int D, int window, int causal, float scale) {
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
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;

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
int launch_nj(const T* q, const T* k, const T* v, T* o, int H, int S, int D,
              int window, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(D, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attention_kernel<NJ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H);
  banded_attention_kernel<NJ, T><<<grid, TPB, smem, st>>>(
      q, k, v, o, S, D, window, causal, 1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int H,
           int S, int D, int window, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  T* O = static_cast<T*>(o);
  // output columns per thread: the fewest instantiated NJ with 16 NJ >= D
  if (D <= 16) return launch_nj<1, T>(Q, K, V, O, H, S, D, window, causal, st);
  if (D <= 32) return launch_nj<2, T>(Q, K, V, O, H, S, D, window, causal, st);
  if (D <= 64) return launch_nj<4, T>(Q, K, V, O, H, S, D, window, causal, st);
  if (D <= 128) return launch_nj<8, T>(Q, K, V, O, H, S, D, window, causal, st);
  if (D <= 160) return launch_nj<10, T>(Q, K, V, O, H, S, D, window, causal, st);
  return launch_nj<16, T>(Q, K, V, O, H, S, D, window, causal, st);
}

}  // namespace

// C entry points, loaded with ctypes.  q, k, v, o are contiguous (H, S, D)
// device arrays of one type; 1 <= H <= 65535, S >= 1, D even and <= 256,
// 1 <= window <= S.  The Python wrapper (kernels/block_attention.py) checks
// all of that; this side only launches.  Returns cudaGetLastError() (or the
// attribute call's error).
extern "C" int banded_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, int H, int S,
                                    int D, int window, int causal,
                                    void* stream) {
  return launch<float>(q, k, v, o, H, S, D, window, causal, stream);
}

extern "C" int banded_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, int H, int S,
                                     int D, int window, int causal,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, H, S, D, window, causal, stream);
}
