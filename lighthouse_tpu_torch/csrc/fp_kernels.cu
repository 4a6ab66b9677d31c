// Hopper kernels for the BLS12-381 field funnels of lighthouse_tpu_torch.
//
// An Fp element is 32 little-endian 12-bit limbs in int32, relaxed: each
// limb in [0, 8191], the value only congruent mod p. An Fp2 element is two
// of them, [2, 32]. These are the JAX package's layouts.
//
// K1 fp_mul_kernel  replaces lighthouse_tpu/crypto/device/pallas_fp.py::
//                   mul_cols_int8 (body _mul_tile_kernel), together with the
//                   reduce_cols its caller fp._mul_pallas_int8 runs after it.
//                   Raw mode writes the 63 exact schoolbook columns,
//                   col[c] = sum_i x[i] * y[c - i]; reduced mode runs the
//                   carry/fold plan on them and writes 32 relaxed limbs.
// K2 fp2_mul_kernel replaces pallas_fp2.py::mul2 (_karatsuba_tile_kernel):
//                   operand sums, three reduced products, the SAT-based
//                   Karatsuba combine, in one launch.
// K3 fp2_sq_kernel  replaces pallas_fp2.py::sq2 (_sq_tile_kernel): rows
//                   (a0+a1, a0) x (a0-a1, a1), c0 = t0, c1 = 2 t1.
//
// What bounds them on this card. The verify path launches them on few
// lanes: from 1 to 3,474 per launch for almost every launch (a mean of
// 44-457 Fp lanes for K1, 216-899 Fp2 lanes for K2 and 110-899 for K3
// per verify), with a handful of K1 launches up to 147,456 lanes from
// pubkey aggregation.
// Such a launch is one wave on 132 SMs, so neither HBM (384 bytes per K1
// lane) nor the int32 pipes (2,240 multiply-adds per K1 lane) bound it:
// its time is the dependent chain of ONE lane's product and reduction.
// The design shortens that chain:
//
// * Plans are straight-line code. The carry/fold plans of fp.plan are
//   generated into fp_tables.h as Plan<limbs, step...> types; Steps walks
//   them at compile time, so every round, every fold's k and the number
//   of live limbs are known to nvcc and every loop unrolls.
// * The fold reads its table from registers: thread t loads column t of
//   FOLD (the first kFoldRows rows, 2^(12 (32 + h)) mod p) once per
//   lane, all loads independent, instead of one load per fold step. (nvcc
//   places them next to the wide fold in K1; forcing them to land at
//   entry measured no faster on an H100.) The high limbs of a wide fold
//   go to the warp's scratch once and come back as 16-byte shared-memory
//   broadcasts; four accumulators split the sum.
// * K2 runs its three products at once: one lane is a block of three
//   warps (a0 b0, a1 b1, (a0+a1)(b0+b1)); after one barrier warps 0 and 1
//   run the two SAT-based combines. One lane per block keeps the small
//   launches spread over the SMs and the resident warps at their
//   register limit for the large ones.
// * K3 runs its two products at once: one lane is a block of two warps.
//   With one warp per lane its time was a launch plus two product chains
//   in series (4.0 us at 1 lane on an H100 against K2's 3.0 us). Its two
//   output halves are independent (c0 needs only t0, c1 only t1), so
//   warp 0 reduces a0+a1 and a0-a1 (two independent Add/Sub plans, two
//   carry-folds each, no scratch), multiplies them and writes c0; warp 1
//   multiplies a0 a1, doubles and writes c1. Each warp has its own
//   scratch and there is no block barrier: a lane costs one product
//   chain plus the short operand reductions, and the launch bounds it
//   (2.8 us at 1 lane against 2.1 us for a one-element torch add, both
//   queued back to back on an H100).
// * K1 keeps one warp per lane (thread t owns columns t, t+32 and t+64),
//   four lanes per block: one product, nothing to split.
//
// The arithmetic is the plan's own, step by step, in exact uint32 (every
// intermediate < 2^31), so the limbs equal the plain versions'.
//
// Why no tensor cores or TMA yet: each lane multiplies its own x by its
// own y, so an int8 mma tile of 16 rows sharing one B operand would be
// 1/16 full, and 1-3,474 lanes per launch have no throughput to win; TMA
// for a 256-byte operand adds a barrier round trip to the latency the
// design removes. The one matrix every lane shares is FOLD (the wide fold
// is hi[n, 33] x FOLD[33, 32]): whether a tensor-core fold pays for the
// large aggregation launches is an open question.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A reduction plan: the number of input limbs, then its steps, 0 for a
// carry round and k > 0 for a fold of the k limbs at and above 32.
template <int... S>
struct Plan {};

}  // namespace

#include "fp_tables.h"

namespace {

constexpr int kNL = 32;
constexpr int kNCols = 63;
constexpr int kW = 12;
constexpr int kMaxLimbs = 96;  // a warp holds limbs t, t+32, t+64 of a lane
constexpr uint32_t kMask = 0xFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLanesPerBlock = 4;  // K1: one warp per lane
constexpr int kHiWords = (kFoldRows + 3) / 4 * 4;

// One lane's limb vector spread over a warp: thread t holds limbs t, t+32,
// t+64. Limbs at or above the current length are zero.
struct Limbs {
  uint32_t a, b, c;
};

// A warp's shared scratch: the product's operand rows and the high limbs
// of a wide fold.
struct alignas(16) WarpScratch {
  uint32_t x[kNL];
  uint32_t y[kNL];
  uint32_t hi[kHiWords];
};

// Column t of the fold table, FOLD[h][t] for h < kFoldRows, in registers.
struct Fold {
  uint32_t r[kFoldRows];
  __device__ __forceinline__ void load(int t) {
#pragma unroll
    for (int h = 0; h < kFoldRows; ++h) r[h] = __ldg(&kFold[h][t]);
  }
};

// new[i] = (old[i] & MASK) + (old[i-1] >> W) on N limbs: one limb wider.
template <int N>
__device__ __forceinline__ void carry_round(Limbs& v, int t) {
  static_assert(N >= kNL && N + 1 <= kMaxLimbs, "plan outside the warp's limbs");
  const uint32_t ca = v.a >> kW;
  const uint32_t ia = __shfl_up_sync(kFull, ca, 1);
  const uint32_t ta = __shfl_sync(kFull, ca, 31);
  if constexpr (N > kNL) {
    const uint32_t cb = v.b >> kW;
    const uint32_t ib = __shfl_up_sync(kFull, cb, 1);
    if constexpr (N >= 2 * kNL) {
      const uint32_t tb = __shfl_sync(kFull, cb, 31);
      if constexpr (N > 2 * kNL) {
        const uint32_t ic = __shfl_up_sync(kFull, v.c >> kW, 1);
        v.c = (v.c & kMask) + (t == 0 ? tb : ic);
      } else {
        v.c = t == 0 ? tb : 0u;
      }
    }
    v.b = (v.b & kMask) + (t == 0 ? ta : ib);
  } else {
    v.b = t == 0 ? ta : 0u;
  }
  v.a = (v.a & kMask) + (t == 0 ? 0u : ia);
}

// out[i] = limb[i] + sum_{h<K} limb[32+h] * FOLD[h][i]: back to 32 limbs.
template <int K>
__device__ __forceinline__ void fold_round(Limbs& v, const Fold& f,
                                           uint32_t* hs, int t) {
  static_assert(K >= 1 && K <= kFoldRows && K <= 2 * kNL, "fold too wide");
  if constexpr (K == 1) {
    v.a += __shfl_sync(kFull, v.b, 0) * f.r[0];
  } else {
    hs[t] = v.b;
    if constexpr (K > kNL) {
      if (t < K - kNL) hs[kNL + t] = v.c;
    }
    __syncwarp();
    uint32_t acc[4] = {v.a, 0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < K; h += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(hs + h);  // broadcast
      const uint32_t hq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (h + j < K) acc[j] += hq[j] * f.r[h + j];
      }
    }
    v.a = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  v.b = 0u;
  v.c = 0u;
}

// A carry round on 32 limbs and the fold of the one new limb, in one
// step: the same integers as the two (fp._carry_fold1).
__device__ __forceinline__ void carry_fold1(Limbs& v, const Fold& f, int t) {
  const uint32_t c = v.a >> kW;
  const uint32_t up = __shfl_up_sync(kFull, c, 1);
  const uint32_t top = __shfl_sync(kFull, c, 31);
  v.a = (v.a & kMask) + (t == 0 ? 0u : up) + top * f.r[0];
}

// Steps<N, s...>::run applies the steps s... to a vector of N limbs.
template <int N, int... S>
struct Steps;

template <int N>
struct Steps<N> {
  __device__ __forceinline__ static void run(Limbs&, const Fold&, uint32_t*,
                                             int) {}
};

template <int N, int K, int... S>
struct Steps<N, K, S...> {
  __device__ __forceinline__ static void run(Limbs& v, const Fold& f,
                                             uint32_t* hs, int t) {
    if constexpr (K == 0) {
      carry_round<N>(v, t);
      Steps<N + 1, S...>::run(v, f, hs, t);
    } else {
      static_assert(N == kNL + K, "a fold takes every limb above 32");
      fold_round<K>(v, f, hs, t);
      Steps<kNL, S...>::run(v, f, hs, t);
    }
  }
};

template <int... S>
struct Steps<kNL, 0, 1, S...> {
  __device__ __forceinline__ static void run(Limbs& v, const Fold& f,
                                             uint32_t* hs, int t) {
    carry_fold1(v, f, t);
    Steps<kNL, S...>::run(v, f, hs, t);
  }
};

template <int N0, int... S>
__device__ __forceinline__ void run_plan(Plan<N0, S...>, Limbs& v,
                                         const Fold& f, uint32_t* hs, int t) {
  Steps<N0, S...>::run(v, f, hs, t);
}

// Limb t of a 32-limb vector reduced by the plan P.
template <class P>
__device__ __forceinline__ uint32_t reduce32(uint32_t x, const Fold& f,
                                             uint32_t* hs, int t) {
  Limbs v{x, 0u, 0u};
  run_plan(P{}, v, f, hs, t);
  return v.a;
}

// Columns t and t+32 of the schoolbook product of the rows xs, ys.
__device__ __forceinline__ Limbs mul_cols(const uint32_t* xs,
                                          const uint32_t* ys, int t) {
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < kNL; i += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(xs + i);  // broadcast
    const uint32_t xq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t p = xq[j] * ys[(t - i - j) & 31];
      if (i + j <= t) {
        lo += p;
      } else {
        hi += p;
      }
    }
  }
  return Limbs{lo, hi, 0u};
}

// Limb t of x * y mod p (relaxed), on the warp's scratch s.
__device__ __forceinline__ uint32_t mul_reduce(uint32_t x, uint32_t y,
                                               WarpScratch& s, const Fold& f,
                                               int t) {
  __syncwarp();  // earlier reads of s are done
  s.x[t] = x;
  s.y[t] = y;
  __syncwarp();
  Limbs v = mul_cols(s.x, s.y, t);
  run_plan(PlanMul{}, v, f, s.hi, t);
  return v.a;
}

template <bool kReduce>
__global__ void __launch_bounds__(kLanesPerBlock * 32)
    fp_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  int32_t* __restrict__ out, int n) {
  __shared__ WarpScratch sm[kLanesPerBlock];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long lane = static_cast<long long>(blockIdx.x) * kLanesPerBlock + w;
  if (lane >= n) return;  // warp-uniform
  WarpScratch& s = sm[w];
  const uint32_t xv = static_cast<uint32_t>(x[lane * kNL + t]);
  const uint32_t yv = static_cast<uint32_t>(y[lane * kNL + t]);
  Fold f;
  if constexpr (kReduce) f.load(t);
  s.x[t] = xv;
  s.y[t] = yv;
  __syncwarp();
  Limbs v = mul_cols(s.x, s.y, t);
  if constexpr (kReduce) {
    run_plan(PlanMul{}, v, f, s.hi, t);
    out[lane * kNL + t] = static_cast<int32_t>(v.a);
  } else {
    int32_t* o = out + lane * kNCols;
    o[t] = static_cast<int32_t>(v.a);
    if (t < kNCols - kNL) o[kNL + t] = static_cast<int32_t>(v.b);
  }
}

// One lane per block of three warps: warp w < 2 computes a_w b_w, warp 2
// (a0+a1)(b0+b1) with the operand sums reduced first (the Add plan).
__global__ void __launch_bounds__(3 * 32)
    fp2_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   int32_t* __restrict__ out) {
  __shared__ WarpScratch sm[3];
  __shared__ uint32_t prod[3][kNL];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int32_t* xl = x + static_cast<long long>(blockIdx.x) * 2 * kNL;
  const int32_t* yl = y + static_cast<long long>(blockIdx.x) * 2 * kNL;
  Fold f;
  uint32_t p, q;
  if (w < 2) {  // warp-uniform
    p = static_cast<uint32_t>(xl[w * kNL + t]);
    q = static_cast<uint32_t>(yl[w * kNL + t]);
    f.load(t);
  } else {
    const uint32_t a0 = static_cast<uint32_t>(xl[t]);
    const uint32_t a1 = static_cast<uint32_t>(xl[kNL + t]);
    const uint32_t b0 = static_cast<uint32_t>(yl[t]);
    const uint32_t b1 = static_cast<uint32_t>(yl[kNL + t]);
    f.load(t);
    p = reduce32<PlanAdd>(a0 + a1, f, sm[2].hi, t);
    q = reduce32<PlanAdd>(b0 + b1, f, sm[2].hi, t);
  }
  prod[w][t] = mul_reduce(p, q, sm[w], f, t);
  __syncthreads();
  if (w == 2) return;
  const uint32_t t0 = prod[0][t], t1 = prod[1][t];
  const uint32_t sat = __ldg(&kSat[t]);
  // products are combined only after reduction: SAT >= LIMB_MAX keeps
  // every limb non-negative
  const uint32_t c =
      w == 0 ? reduce32<PlanSub>(t0 + (sat - t1), f, sm[w].hi, t)
             : reduce32<PlanSub2>(prod[2][t] + (2u * sat - t0 - t1), f,
                                  sm[w].hi, t);
  out[static_cast<long long>(blockIdx.x) * 2 * kNL + w * kNL + t] =
      static_cast<int32_t>(c);
}

// One lane per block of two warps: warp 0 computes c0 = (a0+a1)(a0-a1)
// with the operand sum and difference reduced first (the Add and Sub
// plans), warp 1 c1 = 2 a0 a1 (the Add plan on t1 + t1). The two halves
// share nothing, so no block barrier.
__global__ void __launch_bounds__(2 * 32)
    fp2_sq_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out) {
  __shared__ WarpScratch sm[2];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int32_t* xl = x + static_cast<long long>(blockIdx.x) * 2 * kNL;
  const uint32_t a0 = static_cast<uint32_t>(xl[t]);
  const uint32_t a1 = static_cast<uint32_t>(xl[kNL + t]);
  Fold f;
  f.load(t);
  WarpScratch& s = sm[w];
  uint32_t c;
  if (w == 0) {  // warp-uniform
    const uint32_t sat = __ldg(&kSat[t]);
    const uint32_t sum = reduce32<PlanAdd>(a0 + a1, f, s.hi, t);
    const uint32_t dif = reduce32<PlanSub>(a0 + (sat - a1), f, s.hi, t);
    c = mul_reduce(sum, dif, s, f, t);
  } else {
    const uint32_t t1 = mul_reduce(a0, a1, s, f, t);
    c = reduce32<PlanAdd>(t1 + t1, f, s.hi, t);
  }
  out[static_cast<long long>(blockIdx.x) * 2 * kNL + w * kNL + t] =
      static_cast<int32_t>(c);
}

int blocks_for(int n) { return (n + kLanesPerBlock - 1) / kLanesPerBlock; }

}  // namespace

extern "C" int lh_fp_mul(const void* x, const void* y, void* out, int n,
                         int reduce, void* stream) {
  if (n <= 0) return 0;
  const auto xs = static_cast<const int32_t*>(x);
  const auto ys = static_cast<const int32_t*>(y);
  const auto o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (reduce) {
    fp_mul_kernel<true><<<blocks_for(n), kLanesPerBlock * 32, 0, st>>>(xs, ys, o, n);
  } else {
    fp_mul_kernel<false><<<blocks_for(n), kLanesPerBlock * 32, 0, st>>>(xs, ys, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fp2_mul(const void* x, const void* y, void* out, int n,
                          void* stream) {
  if (n <= 0) return 0;
  fp2_mul_kernel<<<n, 3 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fp2_sq(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  fp2_sq_kernel<<<n, 2 * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
