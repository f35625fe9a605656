// bsmm_pairs: fused gather-GEMM-scatter over block pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bsmm_pairs.py::bsmm_pairs (body
// _kernel).  Computes C[seg[p]] += A[sa[p]] @ B[sb[p]] over P pairs of
// bs x bs blocks, with seg ascending and seg == cap_c marking a dropped pair.
// Sums are kept in float32; C is written once, in A's type.
//
// What bounds it on the H100: at the engine's bs = 32 a pair is 64 KFLOP on
// 8 KB of operands, about 8 FLOP a byte, so the bytes (3.35 TB/s) and the
// float32 FMA rate outside the tensor cores (67 TFLOP/s) are close; the
// operations bound wins once blocks are reused across pairs.  This first
// version is neither: it is bounded by shared-memory traffic and by the
// latency of one pair's load before its FMA loop.
//
// Design.  The TPU kernel walks the pairs in order on one core and carries
// the C block in VMEM from one grid step to the next.  Here blocks run in
// parallel, so one thread block owns one output slot: it finds its run of
// pairs [offsets[s], offsets[s+1]) (the wrapper computes the offsets from
// seg with searchsorted), walks it in order, stages A[sa[p]] and B[sb[p]]
// in shared memory as float32, and keeps the bs x bs partial sums in
// registers.  It stores once; a slot with an empty run stores zeros.  No
// atomics: each C block sums its products in the stable order the engine
// fixes, so results do not change from run to run.  Plain FMA loops; the
// mma/wgmma tiles need bs >= 16 and come with a later, faster version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Threads per block: one per output element up to 256.
template <int BS> struct Shape {
  static constexpr int kElems = BS * BS;
  static constexpr int kThreads = kElems < 256 ? kElems : 256;
  static constexpr int kPer = kElems / kThreads;   // outputs per thread
  static constexpr int kRowStep = kThreads / BS;   // rows between a thread's outputs
};

template <int BS, typename T>
__global__ void __launch_bounds__(Shape<BS>::kThreads)
bsmm_pairs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ sa, const int* __restrict__ sb,
                  const int* __restrict__ offsets, T* __restrict__ c) {
  using S = Shape<BS>;
  // +1 column of padding: threads of a warp that read one column of A in
  // different rows hit different banks
  __shared__ float as[BS][BS + 1];
  __shared__ float bs_[BS][BS];
  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid % BS;          // this thread's column
  const int i0 = tid / BS;         // its first row; the others follow by kRowStep
  const int beg = offsets[slot];
  const int end = offsets[slot + 1];

  float acc[S::kPer];
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) acc[r] = 0.f;

  for (int p = beg; p < end; ++p) {
    const T* ap = a + (size_t)sa[p] * S::kElems;
    const T* bp = b + (size_t)sb[p] * S::kElems;
    __syncthreads();               // the previous pair's reads are done
#pragma unroll
    for (int e = tid; e < S::kElems; e += S::kThreads) {
      as[e / BS][e % BS] = to_f32(ap[e]);
      bs_[e / BS][e % BS] = to_f32(bp[e]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BS; ++k) {
      const float bk = bs_[k][j];
#pragma unroll
      for (int r = 0; r < S::kPer; ++r)
        acc[r] = fmaf(as[i0 + r * S::kRowStep][k], bk, acc[r]);
    }
  }

  T* cp = c + (size_t)slot * S::kElems;
#pragma unroll
  for (int r = 0; r < S::kPer; ++r)
    cp[(i0 + r * S::kRowStep) * BS + j] = from_f32<T>(acc[r]);
}

template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           const void* offsets, void* c, int cap_c, int bs, void* stream) {
  if (cap_c <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int* SA = static_cast<const int*>(sa);
  const int* SB = static_cast<const int*>(sb);
  const int* OFF = static_cast<const int*>(offsets);
  T* C = static_cast<T*>(c);
  switch (bs) {
#define BSMM_CASE(N)                                                         \
  case N:                                                                    \
    bsmm_pairs_kernel<N, T><<<cap_c, Shape<N>::kThreads, 0, st>>>(           \
        A, B, SA, SB, OFF, C);                                               \
    break;
    BSMM_CASE(4)
    BSMM_CASE(8)
    BSMM_CASE(16)
    BSMM_CASE(32)
    BSMM_CASE(64)
#undef BSMM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.  Every pointer is a device pointer;
// offsets has cap_c + 1 int32 entries.  Returns cudaGetLastError().
extern "C" int bsmm_pairs_f32(const void* a, const void* b, const void* sa,
                              const void* sb, const void* offsets, void* c,
                              int cap_c, int bs, void* stream) {
  return launch<float>(a, b, sa, sb, offsets, c, cap_c, bs, stream);
}

extern "C" int bsmm_pairs_bf16(const void* a, const void* b, const void* sa,
                               const void* sb, const void* offsets, void* c,
                               int cap_c, int bs, void* stream) {
  return launch<__nv_bfloat16>(a, b, sa, sb, offsets, c, cap_c, bs, stream);
}
