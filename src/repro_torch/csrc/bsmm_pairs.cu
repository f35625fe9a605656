// bsmm_pairs: fused gather-GEMM-scatter over block pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bsmm_pairs.py::bsmm_pairs (body
// _kernel).  Computes C[seg[p]] += A[sa[p]] @ B[sb[p]] over P pairs of
// bs x bs blocks, with seg ascending and seg == cap_c marking a dropped pair.
// Sums are kept in float32; C is written once, in A's type.  Each C slot's
// value depends only on its own run of pairs, taken in order: not on the
// slot's index, its neighbours, the grid or the SM count.
//
// What bounds it on the H100: at the engine's bs = 32 a pair is 64 KFLOP on
// 8 KB of gathered operands.  In float32 the contract (atol 1e-4, rel 1e-5)
// rules out one-pass TF32, but 3xTF32 (a_hi b_hi + a_hi b_lo + a_lo b_hi,
// x_hi = tf32(x), x_lo = tf32(x - x_hi)) keeps about float32's error, so the
// operations can run on the tensor cores at 495 / 3 TFLOP/s; the unique
// blocks, C and the indices (about 0.09 ms at 3.35 TB/s on the banded wave)
// then bound it.  What holds this design back is the gather: each pair reads
// both of its blocks again (1.36 GB on the banded wave), from L2 or L1, and
// the loads alone, with no arithmetic, take most of the kernel's time.
//
// Design.  The TPU kernel walks the pairs in order on one core and carries
// the C block in VMEM from one grid step to the next.  Here a persistent
// grid (blocks per SM from the occupancy API) runs independent "teams": one
// warp, or at bs 64 the block's four warps.  Team t of T takes the slots t,
// t + T, t + 2T, ..., so the teams of one block work on neighbouring slots
// at the same time, and neighbouring slots of a row of C read the same A
// blocks: A is copied through L1 (.ca) and found there, B, which no
// neighbour shares, through L2 only (.cg), and the shared-memory carveout
// leaves L1 the rest of the SM.  A team consumes the runs of its slots,
// [offsets[s], offsets[s + 1]), as one stream of pairs through its own ring
// of kStages shared-memory stages, each holding one pair's A and B block,
// loaded with cp.async 16 bytes a thread, kStages - 1 pairs ahead of the one
// being computed: the next slot's first pairs load while the current slot's
// last pair computes, which a run of 3-5 pairs could not do alone.  A
// one-warp team orders its ring with __syncwarp alone, so no warp waits for
// another.  The lanes hold a window of 32 entries of sa and sb and hand them
// round with shuffles, so the indices are read once a warp, and the run
// bounds are loaded a slot ahead.  A team owns one C slot at a time and
// keeps it in registers; it stores the slot once when its run ends (zeros
// for an empty run).  No atomics, and a slot's arithmetic is the same
// whichever team computes it.
//
// Two designs, picked by bs (kernels/bsmm_pairs.py::design_for):
// * "mma" (bs 16, 32, 64): tensor cores with mma.sync.  A team owns the whole
//   bs x bs C block as (bs/16) x (bs/8) tiles of m16n8 (at bs 32, one warp
//   and 32 accumulator registers; at bs 64 each of four warps 16 rows).
//   float32: m16n8k8 TF32, three products a tile and k-step, the two small
//   terms first, issued pass by pass so that consecutive mma are
//   independent; the split truncates (see split_tf32).  bfloat16: m16n8k16,
//   whose bf16 x bf16 products are exact in float32.  Each pair is summed in
//   a fresh accumulator and then added to the slot's sums (see Acc::add: the
//   tensor cores' own float32 accumulation drifts over long runs).  A
//   fragments come with ldmatrix (x4; for TF32 each 32-bit element is two
//   b16 halves); bf16 B fragments with ldmatrix.trans; float32 B fragments
//   with scalar loads (TF32 B must be k-contiguous and B rows are n-
//   contiguous).  Rows are padded in shared memory so that each of these
//   reads hits 32 distinct banks: A by 16 bytes, B by 32 (float32) or 16
//   (bf16) bytes.  wgmma is not used: its 64-row tile is larger than a C
//   block at bs 32, and neighbouring pairs share no B.
// * "fma" (bs 4, 8): float32 FMA, each lane one or two outputs of the
//   warp's slot, fed by the same ring (8 stages of one pair each, A copied
//   through L2 only too: L1 does not pay at these sizes).
//
// The run offsets are found by a small kernel launched just before
// (run_offsets_kernel), and out-of-range sa/sb entries are clamped here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int BS, typename T> struct Cfg {
  static constexpr bool kMma = BS >= 16;
  static constexpr int kVec = 16 / sizeof(T);              // elements a 16-byte chunk
  // row strides in shared memory, in elements (see the note on banks)
  static constexpr int kLdA = kMma ? BS + 16 / (int)sizeof(T) : BS;
  static constexpr int kLdB = kMma ? BS + 8 : BS;
  static constexpr int kStageA = BS * kLdA;                // elements of A a stage
  static constexpr int kStage = BS * kLdA + BS * kLdB;     // elements a stage
  static constexpr int kStages = BS <= 8 ? 8 : BS == 16 ? 4 : BS == 32 ? (sizeof(T) == 4 ? 2 : 3) : 3;
  static constexpr int kTeam = BS == 64 ? 4 : 1;           // warps sharing one slot stream
  static constexpr int kWarps = BS == 32 ? 8 : 4;          // warps a block
  static constexpr int kTeams = kWarps / kTeam;            // slot streams a block
  static constexpr int kMaxBlocks = BS == 32 ? 1 : 32;     // resident blocks an SM, at most
  static constexpr bool kL1 = BS >= 16;                    // A copies through L1 (.ca)
  static constexpr int kThreads = 32 * kWarps;
  static constexpr size_t kSmem = sizeof(T) * (size_t)kTeams * kStages * kStage;
  static_assert(kTeam == 1 || kTeams == 1, "a team of several warps is a whole block");
  static_assert((kStageA * sizeof(T)) % 16 == 0 && (kStage * sizeof(T)) % 16 == 0,
                "stages must stay on the 16-byte grid");
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <bool kL1>
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  if constexpr (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// x = hi + lo for 3xTF32: hi is x with the 13 low mantissa bits cleared (a
// TF32 value), lo = x - hi exactly, and the tensor cores read the top 19 bits
// of lo, so lo is truncated to TF32 as well.  Truncation rather than
// cvt.rna.tf32.f32's rounding: one logic operation a part instead of a
// conversion (the split is most of the kernel's ALU work), no carry that
// could turn CUDA's NaN (0x7FFFFFFF) into -0 (a NaN stays a NaN in hi or in
// lo), and about 3x float32's error in a product where rounding has about
// 1x (tests/test_torch_kernels.py::TestTf32Numerics), far inside atol 1e-4.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// the ring: one pair's A and B block a stage, A rows then B rows
// ---------------------------------------------------------------------------

template <int BS, typename T>
__device__ __forceinline__ void issue_pair(T* stage, const T* __restrict__ a,
                                           const T* __restrict__ b, int ia, int ib,
                                           int tl) {
  using C = Cfg<BS, T>;
  constexpr int kChunks = BS * BS / C::kVec;              // 16-byte chunks a block
  constexpr int kN = 32 * C::kTeam;                       // threads of the team
  const T* ga = a + (size_t)ia * (BS * BS);
  const T* gb = b + (size_t)ib * (BS * BS);
#pragma unroll
  for (int i = 0; i < (kChunks + kN - 1) / kN; ++i) {
    const int c = tl + kN * i;
    if (kChunks % kN != 0 && c >= kChunks) break;
    int da = c * C::kVec, db = c * C::kVec;
    if constexpr (C::kMma) {                              // padded rows
      constexpr int kRowChunks = BS / C::kVec;
      const int r = c / kRowChunks, q = (c % kRowChunks) * C::kVec;
      da = r * C::kLdA + q;
      db = r * C::kLdB + q;
    }
    // A through L1, where the teams on neighbouring slots find it; B, which
    // they do not share, through L2 only
    cp_async16<C::kL1>(stage + da, ga + c * C::kVec);
    cp_async16<false>(stage + C::kStageA + db, gb + c * C::kVec);
  }
}

// A team's pair stream, in the order the team consumes it: the runs of its
// slots t, t + T, t + 2T, ... (T teams in all), each run's pairs in order.
// Every lane of the team runs it alike.  sa and sb come from a window of 32
// entries held one a lane and handed round with shuffles.  The run bounds
// of the slot after next and the window of the next slot are loaded one
// slot ahead, so that moving to a new slot waits for no load.
struct Stream {
  const int* sa;
  const int* sb;
  const int* offsets;
  int n_pairs, cap_a, cap_b, cap_c, step;
  int s, p, end;         // current slot, its next pair, the end of its run
  int wbase, wa, wb;     // window start, and this lane's sa, sb entry of it
  int p1, end1, wa1, wb1;  // the run of slot s + step and its window
  int p2, end2;            // the run of slot s + 2 step

  __device__ __forceinline__ void bounds(int slot, int& q, int& e) const {
    q = slot < cap_c ? offsets[slot] : 0;
    e = slot < cap_c ? offsets[slot + 1] : 0;
  }
  __device__ __forceinline__ void window(int from, int lane, int& x, int& y) const {
    const int q = from + lane;
    x = q < n_pairs ? sa[q] : 0;
    y = q < n_pairs ? sb[q] : 0;
  }
  __device__ __forceinline__ void start(int first, int lane) {
    s = first - step;
    p = end = 0;
    bounds(first, p1, end1);
    window(p1, lane, wa1, wb1);
    bounds(first + step, p2, end2);
  }

  // the next pair's clamped (sa, sb); false when the stream is done
  __device__ __forceinline__ bool next(int lane, int& ia, int& ib) {
    while (p == end) {
      s += step;
      if (s >= cap_c) return false;
      p = wbase = p1;
      end = end1;
      wa = wa1;
      wb = wb1;
      p1 = p2;
      end1 = end2;
      window(p1, lane, wa1, wb1);
      bounds(s + 2 * step, p2, end2);
    }
    if (p - wbase >= 32) {               // a run longer than the window
      wbase = p;
      window(p, lane, wa, wb);
    }
    ia = min(max(__shfl_sync(0xffffffffu, wa, p - wbase), 0), cap_a - 1);
    ib = min(max(__shfl_sync(0xffffffffu, wb, p - wbase), 0), cap_b - 1);
    ++p;
    return true;
  }
};

// ---------------------------------------------------------------------------
// per-design accumulators: zero, add one staged pair, store
// ---------------------------------------------------------------------------

template <int BS, typename T, bool kMma = Cfg<BS, T>::kMma> struct Acc;

// tensor cores: (BS/16) x (BS/8) tiles of m16n8
template <int BS, typename T> struct Acc<BS, T, true> {
  using C = Cfg<BS, T>;
  static constexpr int kMT = BS / 16 / C::kTeam, kNT = BS / 8;   // this warp's tiles
  float d[kMT][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[m][n][i] = 0.f;
  }

  // One pair into the slot's sums.  The tensor cores' float32 accumulation
  // does not round to nearest, and its error grows with every mma chained
  // into one accumulator: a run of 64 pairs at bs 16 (384 mma a tile) drifts
  // past atol 1e-4.  So each pair's product is summed in a fresh
  // accumulator t (at most 3 bs / 8 mma deep) and added to d with an IEEE
  // fadd, which keeps the float32 error of the FMA loops.  Warp `rank` of a
  // team owns the rows from rank * kMT * 16 on.
  __device__ __forceinline__ void add(const T* stage, int lane, int rank) {
    const T* sa = stage;
    const T* sb = stage + C::kStageA;
    const int gid = lane >> 2, tig = lane & 3;
    // ldmatrix row addresses: lanes 0-15 rows 0-15 at column 0, lanes 16-31
    // the same rows 16 bytes on (8 bf16 or 4 float32 columns)
    const uint32_t a_base = smem_u32(sa + (rank * kMT * 16 + (lane & 15)) * C::kLdA
                                     + (lane >> 4) * C::kVec);
    const uint32_t b_base = smem_u32(sb + (lane & 15) * C::kLdB + (lane >> 4) * 8);
    float t[kMT][kNT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[m][n][i] = 0.f;
    if constexpr (sizeof(T) == 4) {
      const float* fb = reinterpret_cast<const float*>(sb);
#pragma unroll
      for (int ks = 0; ks < BS / 8; ++ks) {
        uint32_t bh[kNT][2], bl[kNT][2], ah[kMT][4], al[kMT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(fb[(ks * 8 + tig + 4 * h) * C::kLdB + n * 8 + gid], bh[n][h], bl[n][h]);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          uint32_t ar[4];
          ldmatrix_x4(ar, a_base + (uint32_t)((m * 16 * C::kLdA + ks * 8) * sizeof(T)));
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(ar[i]), ah[m][i], al[m][i]);
        }
        // pass by pass, so that the kMT * kNT products of a pass are
        // independent and a tile's next product waits for none of them
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_tf32(t[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_tf32(t[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_tf32(t[m][n], ah[m], bh[n][0], bh[n][1]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < BS / 16; ++ks) {
        uint32_t bf[kNT][2];
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, b_base + (uint32_t)((ks * 16 * C::kLdB + n * 8) * sizeof(T)));
          bf[n][0] = r[0];
          bf[n][1] = r[1];
          bf[n + 1][0] = r[2];
          bf[n + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          uint32_t ar[4];
          ldmatrix_x4(ar, a_base + (uint32_t)((m * 16 * C::kLdA + ks * 16) * sizeof(T)));
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_bf16(t[m][n], ar, bf[n][0], bf[n][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[m][n][i] += t[m][n][i];
  }

  __device__ __forceinline__ void store(T* out, int lane, int rank) const {
    const int gid = lane >> 2, tig = lane & 3;
    out += rank * kMT * 16 * BS;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        T* o = out + (m * 16 + gid) * BS + n * 8 + 2 * tig;
        store2(o, d[m][n][0], d[m][n][1]);
        store2(o + 8 * BS, d[m][n][2], d[m][n][3]);
      }
  }
};

// FMA: lane l owns kPer consecutive outputs of one row (bs 4: lanes 16-31
// repeat lanes 0-15 and store nothing)
template <int BS, typename T> struct Acc<BS, T, false> {
  static constexpr int kElems = BS * BS;
  static constexpr int kPer = kElems >= 32 ? kElems / 32 : 1;
  float d[kPer];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < kPer; ++q) d[q] = 0.f;
  }

  __device__ __forceinline__ void add(const T* stage, int lane, int) {
    const int e0 = (lane * kPer) % kElems;
    const int r = e0 / BS, c0 = e0 % BS;
    const T* sa = stage + r * BS;
    const T* sb = stage + kElems + c0;
#pragma unroll
    for (int k = 0; k < BS; ++k) {
      const float av = to_f32(sa[k]);
#pragma unroll
      for (int q = 0; q < kPer; ++q) d[q] = fmaf(av, to_f32(sb[k * BS + q]), d[q]);
    }
  }

  __device__ __forceinline__ void store(T* out, int lane, int) const {
    if (lane * kPer >= kElems) return;
#pragma unroll
    for (int q = 0; q < kPer; ++q) store1(out + lane * kPer + q, d[q]);
  }
};

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// offsets[s] = the first p with seg[p] >= s (n_pairs if none), s in
// [0, cap_c]: thread p writes the slots in (seg[p - 1], seg[p]], so every
// entry is written exactly once.
__global__ void run_offsets_kernel(const int* __restrict__ seg, int n_pairs, int cap_c,
                                   int* __restrict__ offsets) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p > n_pairs) return;
  const int prev = p == 0 ? -1 : min(seg[p - 1], cap_c);
  const int cur = p == n_pairs ? cap_c : min(seg[p], cap_c);
  for (int s = prev + 1; s <= cur; ++s) offsets[s] = p;
}

template <int BS, typename T>
__global__ void __launch_bounds__(Cfg<BS, T>::kThreads)
bsmm_pairs_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ sa, const int* __restrict__ sb,
                  const int* __restrict__ offsets, T* __restrict__ c,
                  int n_pairs, int cap_a, int cap_b, int cap_c) {
  using C = Cfg<BS, T>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int rank = wib % C::kTeam;       // warp in the team
  const int tl = threadIdx.x % (32 * C::kTeam);   // thread in the team
  const int team = blockIdx.x * C::kTeams + wib / C::kTeam;
  const int n_teams = gridDim.x * C::kTeams;
  // the whole team returns: a team of one warp uses no block barrier, a
  // larger one is the whole block
  if (team >= cap_c) return;
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)(wib / C::kTeam) * S * C::kStage;
  auto team_sync = [] {
    if constexpr (C::kTeam == 1) __syncwarp(); else __syncthreads();
  };

  Stream in{sa, sb, offsets, n_pairs, cap_a, cap_b, cap_c, n_teams};
  in.start(team, lane);
  int ia, ib;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (in.next(lane, ia, ib)) issue_pair<BS, T>(ring + i * C::kStage, a, b, ia, ib, tl);
    cp_async_commit();
  }

  int cs = 0;                            // stage of the pair computed next
  int ps = S - 1;                        // stage of the pair issued next
  Acc<BS, T> acc;
  int beg = offsets[team], end = offsets[team + 1];   // the run of the slot
  for (int slot = team; slot < cap_c; slot += n_teams) {
    int beg1, end1;                      // the next slot's run, loaded ahead
    in.bounds(slot + n_teams, beg1, end1);
    acc.zero();
    for (int p = beg; p < end; ++p) {
      if (in.next(lane, ia, ib)) issue_pair<BS, T>(ring + ps * C::kStage, a, b, ia, ib, tl);
      cp_async_commit();
      ps = ps == S - 1 ? 0 : ps + 1;
      cp_async_wait<S - 1>();          // this lane's copies of the pair landed
      team_sync();                     // and every other thread's of the team
      acc.add(ring + cs * C::kStage, lane, rank);
      cs = cs == S - 1 ? 0 : cs + 1;
      team_sync();                     // the stage is free for the next issue
    }
    acc.store(c + (size_t)slot * (BS * BS), lane, rank);
    beg = beg1;
    end = end1;
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
int launch_bs(const T* a, const T* b, const int* sa, const int* sb, const int* seg,
              int* offsets, T* c, int cap_a, int cap_b, int n_pairs, int cap_c,
              cudaStream_t st) {
  using C = Cfg<BS, T>;
  static int per_sm = 0;    // resident blocks an SM, found once per instantiation
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        bsmm_pairs_kernel<BS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bsmm_pairs_kernel<BS, T>, C::kThreads, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (per_sm > C::kMaxBlocks) per_sm = C::kMaxBlocks;
    // shared memory for per_sm blocks (1 KB each reserved), the rest of the
    // SM's 256 KB to L1, which catches blocks that neighbouring slots reuse
    const int pct = (int)((per_sm * (C::kSmem + 1024) * 100 + 233471) / 233472);
    err = cudaFuncSetAttribute(bsmm_pairs_kernel<BS, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, pct);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  run_offsets_kernel<<<n_pairs / 256 + 1, 256, 0, st>>>(seg, n_pairs, cap_c, offsets);
  const long long full = (long long)per_sm * sms * C::kTeams;
  const long long teams = cap_c < full ? cap_c : full;
  const int blocks = (int)((teams + C::kTeams - 1) / C::kTeams);
  bsmm_pairs_kernel<BS, T><<<blocks, C::kThreads, C::kSmem, st>>>(
      a, b, sa, sb, offsets, c, n_pairs, cap_a, cap_b, cap_c);
  return static_cast<int>(cudaGetLastError());
}

// design: 0 = "fma" (bs 4, 8), 1 = "mma" (bs 16, 32, 64)
template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           const void* seg, void* offsets, void* c, int cap_a, int cap_b,
           int n_pairs, int cap_c, int bs, int design, void* stream) {
  if (cap_c <= 0) return 0;
  if (design != (bs >= 16 ? 1 : 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  const int* SA = static_cast<const int*>(sa);
  const int* SB = static_cast<const int*>(sb);
  const int* SEG = static_cast<const int*>(seg);
  int* OFF = static_cast<int*>(offsets);
  T* Cp = static_cast<T*>(c);
  switch (bs) {
#define BSMM_CASE(N) \
  case N: return launch_bs<N, T>(A, B, SA, SB, SEG, OFF, Cp, cap_a, cap_b, n_pairs, cap_c, st);
    BSMM_CASE(4)
    BSMM_CASE(8)
    BSMM_CASE(16)
    BSMM_CASE(32)
    BSMM_CASE(64)
#undef BSMM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, loaded with ctypes.  Every pointer is a device pointer; the
// block stacks start on the 16-byte grid (the wrapper, kernels/bsmm_pairs.py,
// sees to that); offsets is scratch of cap_c + 1 int32 entries.  Returns
// cudaGetLastError().
extern "C" int bsmm_pairs_f32(const void* a, const void* b, const void* sa,
                              const void* sb, const void* seg, void* offsets,
                              void* c, int cap_a, int cap_b, int n_pairs,
                              int cap_c, int bs, int design, void* stream) {
  return launch<float>(a, b, sa, sb, seg, offsets, c, cap_a, cap_b, n_pairs,
                       cap_c, bs, design, stream);
}

extern "C" int bsmm_pairs_bf16(const void* a, const void* b, const void* sa,
                               const void* sb, const void* seg, void* offsets,
                               void* c, int cap_a, int cap_b, int n_pairs,
                               int cap_c, int bs, int design, void* stream) {
  return launch<__nv_bfloat16>(a, b, sa, sb, seg, offsets, c, cap_a, cap_b,
                               n_pairs, cap_c, bs, design, stream);
}
