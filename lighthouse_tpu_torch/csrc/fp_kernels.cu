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
// What bounds them on this card: per Fp product a lane reads 256 bytes and
// writes 128 (252 raw columns), against 1024 int32 multiply-adds for the
// columns and about 1200 more for the folds of the reduction: some 6 int32
// multiply-adds per byte, above the card's int32-rate / memory-rate ratio
// (about 5), so the int32 pipes bound them, not HBM. The TPU kernel split
// limbs into int8 halves and built a [32, 63] banded-Toeplitz copy of y
// only because the MXU takes int8 operands; here the columns come straight
// from the two 32-limb rows, in uint32 (every column < 2^31, no signed
// overflow).
//
// Design: correctness first. One warp per lane: thread t owns limbs t,
// t+32 and t+64 of the lane's columns; products read the two rows from
// shared memory, carries move between threads by shuffles, folds read the
// 2^(12 i) mod p table. The carry/fold plans are the port's own reduce_cols
// plans (fp.plan), generated into fp_tables.h at build time, so kernel and
// plain version agree limb for limb. Tensor-core paths (wgmma / mma.sync
// on s8 halves), TMA staging and several lanes per warp are left for later.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_tables.h"

namespace {

constexpr int kNL = 32;
constexpr int kNCols = 63;
constexpr int kW = 12;
constexpr uint32_t kMask = 0xFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;  // lanes per block

// One lane's limb vector spread over a warp: thread t holds limbs t, t+32,
// t+64. Limbs at or above the current length are zero.
struct Limbs {
  uint32_t a, b, c;
};

// new[i] = (old[i] & MASK) + (old[i-1] >> W): one limb wider. The plans
// keep the length <= 96, so the carry out of limb 95 is always zero.
__device__ __forceinline__ void carry_round(Limbs& v, int t) {
  const uint32_t ca = v.a >> kW, cb = v.b >> kW, cc = v.c >> kW;
  uint32_t ia = __shfl_up_sync(kFull, ca, 1);
  uint32_t ib = __shfl_up_sync(kFull, cb, 1);
  uint32_t ic = __shfl_up_sync(kFull, cc, 1);
  const uint32_t ta = __shfl_sync(kFull, ca, 31);
  const uint32_t tb = __shfl_sync(kFull, cb, 31);
  if (t == 0) {
    ia = 0u;
    ib = ta;
    ic = tb;
  }
  v.a = (v.a & kMask) + ia;
  v.b = (v.b & kMask) + ib;
  v.c = (v.c & kMask) + ic;
}

// out[i] = limb[i] + sum_{h<k} limb[32+h] * FOLD[h][i]: back to 32 limbs.
__device__ __forceinline__ void fold_round(Limbs& v, int t, int k) {
  uint32_t acc = v.a;
  for (int h = 0; h < k; ++h) {
    const uint32_t hi =
        (h < 32) ? __shfl_sync(kFull, v.b, h) : __shfl_sync(kFull, v.c, h - 32);
    acc += hi * __ldg(&kFold[h][t]);
  }
  v.a = acc;
  v.b = 0u;
  v.c = 0u;
}

// A plan step is 0 for a carry round, k > 0 for a fold of k high limbs.
__device__ __forceinline__ void run_plan(Limbs& v, int t, const int* plan,
                                         int len) {
  for (int s = 0; s < len; ++s) {
    const int k = plan[s];
    if (k == 0) {
      carry_round(v, t);
    } else {
      fold_round(v, t, k);
    }
  }
}

// Columns t and t+32 of the schoolbook product of the rows xs, ys.
__device__ __forceinline__ Limbs mul_cols(const uint32_t* xs,
                                          const uint32_t* ys, int t) {
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < kNL; ++i) {
    const uint32_t p = xs[i] * ys[(t - i) & 31];
    if (i <= t) {
      lo += p;
    } else {
      hi += p;
    }
  }
  return Limbs{lo, hi, 0u};
}

// Limb t of x * y mod p (relaxed); sm is this warp's 64-word scratch.
__device__ __forceinline__ uint32_t mul_reduce(uint32_t x, uint32_t y,
                                               uint32_t* sm, int t) {
  __syncwarp();
  sm[t] = x;
  sm[kNL + t] = y;
  __syncwarp();
  Limbs v = mul_cols(sm, sm + kNL, t);
  run_plan(v, t, kPlanMul, kPlanMulLen);
  return v.a;
}

// Limb t of a 32-limb column vector reduced by the given plan.
__device__ __forceinline__ uint32_t reduce32(uint32_t x, int t,
                                             const int* plan, int len) {
  Limbs v{x, 0u, 0u};
  run_plan(v, t, plan, len);
  return v.a;
}

__global__ void __launch_bounds__(kWarps * 32)
    fp_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  int32_t* __restrict__ out, int n, int reduce) {
  __shared__ uint32_t sm[kWarps][2 * kNL];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long lane = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (lane >= n) return;  // warp-uniform
  uint32_t* s = sm[w];
  s[t] = static_cast<uint32_t>(x[lane * kNL + t]);
  s[kNL + t] = static_cast<uint32_t>(y[lane * kNL + t]);
  __syncwarp();
  Limbs v = mul_cols(s, s + kNL, t);
  if (!reduce) {
    int32_t* o = out + lane * kNCols;
    o[t] = static_cast<int32_t>(v.a);
    if (t < kNCols - kNL) o[kNL + t] = static_cast<int32_t>(v.b);
    return;
  }
  run_plan(v, t, kPlanMul, kPlanMulLen);
  out[lane * kNL + t] = static_cast<int32_t>(v.a);
}

__global__ void __launch_bounds__(kWarps * 32)
    fp2_mul_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   int32_t* __restrict__ out, int n) {
  __shared__ uint32_t sm[kWarps][2 * kNL];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long lane = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (lane >= n) return;  // warp-uniform
  const int32_t* xl = x + lane * 2 * kNL;
  const int32_t* yl = y + lane * 2 * kNL;
  const uint32_t a0 = static_cast<uint32_t>(xl[t]);
  const uint32_t a1 = static_cast<uint32_t>(xl[kNL + t]);
  const uint32_t b0 = static_cast<uint32_t>(yl[t]);
  const uint32_t b1 = static_cast<uint32_t>(yl[kNL + t]);
  // the operand sums are reduced before they enter a product
  const uint32_t sa = reduce32(a0 + a1, t, kPlanAdd, kPlanAddLen);
  const uint32_t sb = reduce32(b0 + b1, t, kPlanAdd, kPlanAddLen);
  uint32_t* s = sm[w];
  const uint32_t t0 = mul_reduce(a0, b0, s, t);
  const uint32_t t1 = mul_reduce(a1, b1, s, t);
  const uint32_t m = mul_reduce(sa, sb, s, t);
  const uint32_t sat = kSat[t];
  // products are combined only after reduction: SAT >= LIMB_MAX keeps
  // every limb non-negative
  const uint32_t c0 = reduce32(t0 + (sat - t1), t, kPlanSub, kPlanSubLen);
  const uint32_t c1 =
      reduce32(m + (2u * sat - t0 - t1), t, kPlanSub2, kPlanSub2Len);
  out[lane * 2 * kNL + t] = static_cast<int32_t>(c0);
  out[lane * 2 * kNL + kNL + t] = static_cast<int32_t>(c1);
}

__global__ void __launch_bounds__(kWarps * 32)
    fp2_sq_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int n) {
  __shared__ uint32_t sm[kWarps][2 * kNL];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long lane = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (lane >= n) return;  // warp-uniform
  const int32_t* xl = x + lane * 2 * kNL;
  const uint32_t a0 = static_cast<uint32_t>(xl[t]);
  const uint32_t a1 = static_cast<uint32_t>(xl[kNL + t]);
  const uint32_t sat = kSat[t];
  const uint32_t sum = reduce32(a0 + a1, t, kPlanAdd, kPlanAddLen);
  const uint32_t dif = reduce32(a0 + (sat - a1), t, kPlanSub, kPlanSubLen);
  uint32_t* s = sm[w];
  const uint32_t t0 = mul_reduce(sum, dif, s, t);
  const uint32_t t1 = mul_reduce(a0, a1, s, t);
  const uint32_t c1 = reduce32(t1 + t1, t, kPlanAdd, kPlanAddLen);
  out[lane * 2 * kNL + t] = static_cast<int32_t>(t0);
  out[lane * 2 * kNL + kNL + t] = static_cast<int32_t>(c1);
}

int blocks_for(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int lh_fp_mul(const void* x, const void* y, void* out, int n,
                         int reduce, void* stream) {
  if (n <= 0) return 0;
  fp_mul_kernel<<<blocks_for(n), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), n, reduce);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fp2_mul(const void* x, const void* y, void* out, int n,
                          void* stream) {
  if (n <= 0) return 0;
  fp2_mul_kernel<<<blocks_for(n), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh_fp2_sq(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  fp2_sq_kernel<<<blocks_for(n), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
