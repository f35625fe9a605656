// batched_gemm: C[p] = A[p] @ B[p] over a (P, bs, bs) stack, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/batched_gemm.py::batched_gemm
// (body _kernel).  Sums are kept in float32; C is written in A's type.
//
// What bounds it on the H100: every product reads 2 bs^2 inputs and writes
// bs^2 outputs for 2 bs^3 operations, 2 bs / 3 / sizeof(T) FLOP a byte: at
// bs = 32 in float32 about 5, so it is bytes-bound at 3.35 TB/s (the float32
// FMA peak of 67 TFLOP/s needs 20 a byte).  At the bytes bound the FMAs use
// about a quarter of the FMA peak, so plain float32 FMA (no TF32, which the
// float32 contract of atol 1e-4 would not allow) is enough; what the kernel
// needs is device memory kept busy and few shared-memory loads per FMA.
//
// Design.  The TPU kernel feeds the MXU a (block_t, bs, bs) slab per grid
// step and pads P to a multiple of block_t.  Here the grid is persistent:
// as many 256-thread blocks as fit on the card at once (from the occupancy
// API), each walking steps s = blockIdx.x, += gridDim.x.  A step is
// G = 256 / (bs^2 / (RT CT)) consecutive products, so its A and B are two
// contiguous runs of G bs^2 elements.  They go into a ring of kStages
// stages with cp.async, 16 bytes a thread, kStages - 1 steps ahead of the
// one being computed, so device-memory reads stay in flight while the block
// computes.  A's rows are padded by 16 bytes in shared memory so that the
// threads of a quarter-warp reading different rows hit different banks.
// Each thread owns an RT x 4 register tile (RT = 2, or 4 at bs = 64) of one
// product and reads 4 k-steps at a time: one 16-byte load of A per row and
// one of B per k, 0.19 shared loads per FMA at RT = 2 (0.125 at RT = 4),
// against 1.25 in the first version.  Each row of the tile is stored with
// one 16-byte (float32) or 8-byte (bfloat16) store.  The ragged last step
// copies and stores only the products that exist, so any P works and no
// padding is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;

template <int BS, typename T> struct Shape {
  static constexpr int kRT = BS == 64 ? 4 : 2;          // rows of a thread's tile
  static constexpr int kCT = 4;                         // columns of the tile
  static constexpr int kTP = BS * BS / (kRT * kCT);     // threads a product
  static constexpr int kGroup = kThreads / kTP;         // products a step
  static constexpr int kElems = BS * BS;
  static constexpr int kVec = 16 / sizeof(T);           // elements a 16-byte chunk
  // A's row stride in shared memory: padded by 16 bytes where a row holds
  // whole 16-byte chunks (every case but bs = 4 in bfloat16)
  static constexpr int kALd = BS % kVec == 0 ? BS + kVec : BS;
  static constexpr int kAStage = kGroup * BS * kALd;    // elements a stage
  static constexpr int kBStage = kGroup * kElems;
  static constexpr int kChunks = kGroup * kElems / kVec;  // 16-byte chunks an operand
  static constexpr size_t kSmem = sizeof(T) * (size_t)kStages * (kAStage + kBStage);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive elements of shared memory as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Start the copies of step `step` (products step * G .. , `here` of them)
// into one stage: A row by row into the padded layout, B as it is.
template <int BS, typename T>
__device__ __forceinline__ void issue_step(T* as, T* bs, const T* __restrict__ a,
                                           const T* __restrict__ b, long long first,
                                           int here) {
  using S = Shape<BS, T>;
  const size_t base = (size_t)first * S::kElems;
  for (int c = threadIdx.x; c < S::kChunks; c += kThreads) {
    const int e = c * S::kVec;                 // element offset in the step
    if (e >= here * S::kElems) break;          // chunks run in element order
    if constexpr (S::kALd == BS) {             // a row is under 16 bytes: no padding
      cp_async16(as + e, a + base + e);
    } else {
      constexpr int kRowChunks = BS / S::kVec;
      cp_async16(as + (c / kRowChunks) * S::kALd + (c % kRowChunks) * S::kVec,
                 a + base + e);
    }
    cp_async16(bs + e, b + base + e);
  }
}

template <int BS, typename T>
__global__ void __launch_bounds__(kThreads)
batched_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int n_prod) {
  using S = Shape<BS, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_ring = reinterpret_cast<T*>(smem_raw);
  T* b_ring = a_ring + kStages * S::kAStage;

  const int n_steps = (n_prod + S::kGroup - 1) / S::kGroup;
  const int mine = blockIdx.x < n_steps
                       ? (n_steps - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto here_of = [&](int i) {
    const long long first = (long long)((int)blockIdx.x + i * (int)gridDim.x) * S::kGroup;
    const long long left = (long long)n_prod - first;
    return left < S::kGroup ? (int)left : S::kGroup;
  };
  auto first_of = [&](int i) {
    return (long long)((int)blockIdx.x + i * (int)gridDim.x) * S::kGroup;
  };

  // the thread's place: product g of the step, tile rows tr * RT .., columns tc * 4 ..
  const int g = threadIdx.x / S::kTP;
  const int tl = threadIdx.x % S::kTP;
  const int tc = tl % (BS / S::kCT);
  const int tr = tl / (BS / S::kCT);
  const int r0 = tr * S::kRT, c0 = tc * S::kCT;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine)
      issue_step<BS, T>(a_ring + i * S::kAStage, b_ring + i * S::kBStage, a, b,
                        first_of(i), here_of(i));
    cp_async_commit();
  }

  for (int i = 0; i < mine; ++i) {
    {
      const int j = i + kStages - 1;    // the step kStages - 1 ahead
      if (j < mine)
        issue_step<BS, T>(a_ring + (j % kStages) * S::kAStage,
                          b_ring + (j % kStages) * S::kBStage, a, b, first_of(j),
                          here_of(j));
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();       // this thread's copies of step i landed
    __syncthreads();                    // and every other thread's

    const int here = here_of(i);
    const T* as = a_ring + (i % kStages) * S::kAStage + g * BS * S::kALd + r0 * S::kALd;
    const T* bs = b_ring + (i % kStages) * S::kBStage + g * S::kElems + c0;
    float acc[S::kRT][S::kCT];
#pragma unroll
    for (int r = 0; r < S::kRT; ++r)
#pragma unroll
      for (int q = 0; q < S::kCT; ++q) acc[r][q] = 0.f;
#pragma unroll
    for (int k = 0; k < BS; k += 4) {
      float4 av[S::kRT], bv[4];
#pragma unroll
      for (int r = 0; r < S::kRT; ++r) av[r] = load4(as + r * S::kALd + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bv[kk] = load4(bs + (k + kk) * BS);
#pragma unroll
      for (int r = 0; r < S::kRT; ++r) {
        const float ar[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r][0] = fmaf(ar[kk], bv[kk].x, acc[r][0]);
          acc[r][1] = fmaf(ar[kk], bv[kk].y, acc[r][1]);
          acc[r][2] = fmaf(ar[kk], bv[kk].z, acc[r][2]);
          acc[r][3] = fmaf(ar[kk], bv[kk].w, acc[r][3]);
        }
      }
    }
    if (g < here) {
      T* out = c + (size_t)(first_of(i) + g) * S::kElems + (size_t)r0 * BS + c0;
#pragma unroll
      for (int r = 0; r < S::kRT; ++r)
        store4(out + r * BS, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();                    // stage i % kStages is free again
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int BS, typename T>
int launch_bs(const T* a, const T* b, T* c, int n_prod, cudaStream_t st) {
  using S = Shape<BS, T>;
  static int per_sm = 0;    // resident blocks an SM, found once per instantiation
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        batched_gemm_kernel<BS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, batched_gemm_kernel<BS, T>, kThreads, S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int n_steps = (n_prod + S::kGroup - 1) / S::kGroup;
  const int blocks = n_steps < per_sm * sms ? n_steps : per_sm * sms;
  batched_gemm_kernel<BS, T><<<blocks, kThreads, S::kSmem, st>>>(a, b, c, n_prod);
  return static_cast<int>(cudaGetLastError());
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
    case 4: return launch_bs<4, T>(A, B, C, n_prod, st);
    case 8: return launch_bs<8, T>(A, B, C, n_prod, st);
    case 16: return launch_bs<16, T>(A, B, C, n_prod, st);
    case 32: return launch_bs<32, T>(A, B, C, n_prod, st);
    case 64: return launch_bs<64, T>(A, B, C, n_prod, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, loaded with ctypes.  Every pointer is a 16-byte-aligned
// device pointer to n_prod contiguous bs x bs blocks (the wrapper,
// kernels/batched_gemm.py, checks that).  Returns cudaGetLastError().
extern "C" int batched_gemm_f32(const void* a, const void* b, void* c,
                                int n_prod, int bs, void* stream) {
  return launch<float>(a, b, c, n_prod, bs, stream);
}

extern "C" int batched_gemm_bf16(const void* a, const void* b, void* c,
                                 int n_prod, int bs, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, n_prod, bs, stream);
}
