// Per-pair alpha math and the front-to-back step rule shared by the forward
// (composite_fwd.cu, K1) and backward (composite_bwd.cu, K2) composite
// kernels. Both kernels must walk each pixel's list identically: K2 replays
// K1's walk to find where each pixel stopped, so an instance that K1 applied
// is exactly one that K2 differentiates. The products and sums below are
// written with explicit roundings (__fmul_rn, __fadd_rn, __fmaf_rn), so the
// compiler cannot contract them differently in the two kernels.
//
// The tests are left to the caller, one early `continue` each, in the order
// parity rect, power <= 0, alpha >= alpha_min, crossing. The rect test is
// written out in each kernel's loop: as a function returning a bool, nvcc
// turned its four short-circuit compares into a predicated block that
// materializes the bool before one branch, and K1, whose pairs mostly fail
// that test, took ~10% longer on an H100 (utils/kernel_ab.py, its SASS dumps).

#pragma once

#include <cuda_runtime.h>

namespace lidargs {

constexpr int kOutRows = 8;
constexpr int kMaxC = 6;       // C + 2 <= kOutRows

// PackedCols columns (lidargs_torch/ops/projection.py)
constexpr int kMean = 0, kU1 = 3, kU2 = 6, kConic = 9, kOpacity = 12, kDepth = 13,
              kFeat0 = 14;

// The geometry of one (instance row, pixel) pair.
struct PairGeom {
  float dx, dy, dz;    // sphere mean - ray dir
  float ddx, ddy;      // offsets on the unit cross-section basis u1, u2
  float power;         // -0.5 (a ddx^2 + c ddy^2) - b ddx ddy
  float e;             // exp(power)
  float araw;          // opacity * e
  float alpha;         // min(araw, alpha_clamp)
};

// dx .. power of the pair. No /|u|^2: the packed u1, u2 are unit vectors.
// The roundings are those nvcc chose for the plain expressions
//   ddx = dx u1x + dy u1y + dz u1z,  power = -0.5 (a ddx^2 + c ddy^2) - b ddx ddy,
// so K1 gives the same bits as when it wrote them out.
__device__ __forceinline__ void pair_power(const float* __restrict__ r, float dirx,
                                           float diry, float dirz, PairGeom& g) {
  g.dx = __fadd_rn(r[kMean], -dirx);
  g.dy = __fadd_rn(r[kMean + 1], -diry);
  g.dz = __fadd_rn(r[kMean + 2], -dirz);
  g.ddx = __fmaf_rn(g.dz, r[kU1 + 2], __fmaf_rn(g.dx, r[kU1], __fmul_rn(g.dy, r[kU1 + 1])));
  g.ddy = __fmaf_rn(g.dz, r[kU2 + 2], __fmaf_rn(g.dx, r[kU2], __fmul_rn(g.dy, r[kU2 + 1])));
  const float quad = __fmaf_rn(__fmul_rn(r[kConic], g.ddx), g.ddx,
                               __fmul_rn(__fmul_rn(r[kConic + 2], g.ddy), g.ddy));
  g.power = __fmaf_rn(quad, -0.5f, -__fmul_rn(__fmul_rn(r[kConic + 1], g.ddx), g.ddy));
}

// e, araw and alpha of a pair with power <= 0. NaN stays NaN and fails the
// caller's alpha >= alpha_min.
__device__ __forceinline__ void pair_alpha(const float* __restrict__ r, float alpha_clamp,
                                           PairGeom& g) {
  g.e = expf(g.power);
  g.araw = __fmul_rn(r[kOpacity], g.e);
  g.alpha = g.araw > alpha_clamp ? alpha_clamp : g.araw;
}

// The transmittance after a passed instance, T * (1 - alpha). Below t_min
// it is the crossing: that instance is not applied and the pixel is done.
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fadd_rn(1.f, -alpha));
}

}  // namespace lidargs
