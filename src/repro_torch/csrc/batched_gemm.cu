// batched_gemm: C[p] = A[p] @ B[p] over a (P, bs, bs) stack, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/batched_gemm.py::batched_gemm
// (body _kernel).  Sums are kept in float32; C is written in A's type.
//
// What bounds it on the H100: every product reads 2 bs^2 inputs and writes
// bs^2 outputs for 2 bs^3 operations, 2 bs / 3 / sizeof(T) FLOP a byte: at
// bs = 32 in float32 about 5, so it is bytes-bound at 3.35 TB/s (the float32
// FMA peak of 67 TFLOP/s needs 20 a byte).  This first version is bounded
// instead by shared-memory traffic in its FMA loop.
//
// Design.  The TPU kernel feeds the MXU a (block_t, bs, bs) slab per grid
// step and pads P to a multiple of block_t.  Here one thread block takes one
// product, or G = 256 / bs^2 products when bs <= 8 so that a block still has
// 256 threads; the ragged last block masks its missing products, so no
// padding is needed.  Operands are staged in shared memory as float32, each
// thread keeps its outputs in registers and stores them once.  Plain FMA
// loops; mma/wgmma tiles need bs >= 16 and come with a later version.
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

template <int BS> struct Shape {
  static constexpr int kElems = BS * BS;
  static constexpr int kGroup = kElems < 256 ? 256 / kElems : 1;  // products a block
  static constexpr int kThreads = kElems * kGroup < 256 ? kElems * kGroup : 256;
  static constexpr int kPer = kElems * kGroup / kThreads;          // outputs a thread
  static constexpr int kRowStep = kThreads / BS;  // rows between a thread's outputs
};

template <int BS, typename T>
__global__ void __launch_bounds__(Shape<BS>::kThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int n_prod) {
  using S = Shape<BS>;
  constexpr int kRows = S::kGroup * BS;   // the group's products, stacked by rows
  __shared__ float as[kRows][BS + 1];
  __shared__ float bs_[kRows][BS];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * S::kGroup;
  const long long left = (long long)n_prod - first;
  const int here = left < S::kGroup ? (int)left : S::kGroup;
  const size_t base = (size_t)first * S::kElems;

#pragma unroll
  for (int e = tid; e < S::kElems * S::kGroup; e += S::kThreads) {
    const bool ok = e < here * S::kElems;
    as[e / BS][e % BS] = ok ? to_f32(a[base + e]) : 0.f;
    bs_[e / BS][e % BS] = ok ? to_f32(b[base + e]) : 0.f;
  }
  __syncthreads();

  // output (row, j) of the stacked group: row / BS is the product, row % BS
  // its row; B's rows for that product start at (row / BS) * BS
  const int j = tid % BS;
  const int row0 = tid / BS;
  float acc[S::kPer];
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < BS; ++k) {
#pragma unroll
    for (int r = 0; r < S::kPer; ++r) {
      const int row = row0 + r * S::kRowStep;
      acc[r] = fmaf(as[row][k], bs_[(row / BS) * BS + k][j], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const int row = row0 + r * S::kRowStep;
    if (row / BS < here) c[base + (size_t)row * BS + j] = from_f32<T>(acc[r]);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int n_prod, int bs,
           void* stream) {
  if (n_prod <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  switch (bs) {
#define GEMM_CASE(N)                                                         \
  case N: {                                                                  \
    const int blocks = (n_prod + Shape<N>::kGroup - 1) / Shape<N>::kGroup;   \
    batched_gemm_kernel<N, T><<<blocks, Shape<N>::kThreads, 0, st>>>(        \
        A, B, C, n_prod);                                                    \
    break;                                                                   \
  }
    GEMM_CASE(4)
    GEMM_CASE(8)
    GEMM_CASE(16)
    GEMM_CASE(32)
    GEMM_CASE(64)
#undef GEMM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.  Every pointer is a device pointer to
// n_prod contiguous bs x bs blocks.  Returns cudaGetLastError().
extern "C" int batched_gemm_f32(const void* a, const void* b, void* c,
                                int n_prod, int bs, void* stream) {
  return launch<float>(a, b, c, n_prod, bs, stream);
}

extern "C" int batched_gemm_bf16(const void* a, const void* b, void* c,
                                 int n_prod, int bs, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, n_prod, bs, stream);
}
