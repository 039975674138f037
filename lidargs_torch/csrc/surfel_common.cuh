// Per-pair surfel math shared by the surfel forward (surfel_fwd.cu, K5) and
// backward (surfel_bwd.cu, K6) kernels: the exact ray-plane intersection with
// the rho2d low-pass fallback, the depth of the pair, its alpha. The step
// rule is composite_common.cuh's `transmit`, as in K1 and K2.
//
// K6 replays K5's walk and routes the median depth's cotangent to the row
// whose depth equals K5's saved median, so the two kernels must compute each
// pair's depth, alpha and transmittance with the same bits. Every product,
// sum and quotient here is written with an explicit rounding (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc may not contract into an
// FMA, and in the order of the plain PyTorch version
// (lidargs_torch/ops/surfel.py `pair_geometry`): a sum of three products is
// (a0 b0 + a1 b1) + a2 b2. So the kernels and the plain versions agree on a
// pair's depth bit for bit as well, as far as their elementwise operations
// round alike (expf is the same libdevice function).
//
// The tests are left to the caller, one early `continue` each, in the order
// valid flag, parity rect (written out in each kernel's loop: see
// composite_common.cuh), hit and near cut and power <= 0, alpha >= alpha_min,
// crossing.

#pragma once

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace lidargs {

constexpr int kSurfelOutRows = 16;
constexpr int kPixRows = 8;         // rows of a pixel block: dir xyz, column, row, 0, 0, 0
constexpr int kSurfelMaxC = 7;       // C + 9 <= kSurfelOutRows

// SurfelCols columns (lidargs_torch/ops/surfel.py)
constexpr int kTu = 0, kTv = 3, kTw = 6, kNrm = 9, kSOpacity = 12, kSDepth = 13,
              kSFeat0 = 14;

// The float constants of a launch, each already rounded to float32 as the
// plain version rounds the same Python scalar.
struct SurfelConsts {
  float alpha_min, alpha_clamp, t_min;
  float near;         // surfel_near: the per-pair depth cut, and the distortion map's near
  float fis;          // filter_inv_square of rho2d
  float m_scale;      // far / (far - near): m = m_scale (1 - near / max(depth, depth_floor))
  float m_dscale;     // far / (far - near) * near: dm/ddepth = m_dscale / depth^2
  float depth_floor;  // 1e-9
};

// The geometry of one (surfel row, pixel) pair.
struct SurfelGeom {
  float tu_sq, tv_sq, tw_sq;  // |Tu|^2, |Tv|^2, |Tw|^2
  float tu_tu, tv_tv;         // the same, clamped below at 1e-20
  float rho_r;                // sqrt(max(|Tw|^2, 1e-20)): the center range
  bool hit;                   // dir . n != 0
  float cos2s;                // dir . n where hit, else 1
  float lam2;                 // (Tw . n) / cos2s
  float dpx, dpy, dpz;        // lam2 dir - Tw
  float sx, sy;               // (dp . Tu) / tu_tu, (dp . Tv) / tv_tv
  float dxc, dyc;             // center column - pixel column, center row - pixel row
  bool use3d;                 // lam2 > 0 and rho3d <= rho2d: the plane's value is taken
  float depth;                // lam2 where use3d, else rho_r
  float power;                // -rho / 2
  float e, araw, alpha;       // exp(power), opacity * e, min(araw, alpha_clamp)
};

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2, float b0, float b1,
                                         float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// max(x, lo) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

// What a pair's geometry needs of its row alone. K5/K7 compute it once per
// staged row (surfel_fwd.cu); K6 per pair, through `surfel_pair`.
struct SurfelRow {
  float rho_r;         // sqrt(max(|Tw|^2, 1e-20)): the center range
  float lam;           // Tw . n
  float tu_tu, tv_tv;  // |Tu|^2, |Tv|^2 clamped below at 1e-20
};

// The row part of `surfel_pair`: q, and the squares |Tw|^2, |Tu|^2, |Tv|^2
// before their clamps (K6's chain reads them).
__device__ __forceinline__ void surfel_row(const float* __restrict__ r, SurfelRow& q,
                                           float& tw_sq, float& tu_sq, float& tv_sq) {
  const float tux = r[kTu], tuy = r[kTu + 1], tuz = r[kTu + 2];
  const float tvx = r[kTv], tvy = r[kTv + 1], tvz = r[kTv + 2];
  const float twx = r[kTw], twy = r[kTw + 1], twz = r[kTw + 2];
  tw_sq = dot3_rn(twx, twy, twz, twx, twy, twz);
  q.rho_r = __fsqrt_rn(clamp_lo(tw_sq, 1e-20f));
  q.lam = dot3_rn(twx, twy, twz, r[kNrm], r[kNrm + 1], r[kNrm + 2]);
  tu_sq = dot3_rn(tux, tuy, tuz, tux, tuy, tuz);
  tv_sq = dot3_rn(tvx, tvy, tvz, tvx, tvy, tvz);
  q.tu_tu = clamp_lo(tu_sq, 1e-20f);
  q.tv_tv = clamp_lo(tv_sq, 1e-20f);
}

// The pair part of `surfel_pair`: everything up to `power` from the row's
// part q, for the row `r` (kCen: its center column) and a pixel with unit
// ray (dirx, diry, dirz) at column px, row py. Leaves g.tw_sq, g.tu_sq and
// g.tv_sq as they were. Every operation rounds on its own, so the order in
// which the two parts run does not change a bit.
__device__ __forceinline__ void surfel_pair_at(const float* __restrict__ r, const SurfelRow& q,
                                               int kCen, float dirx, float diry, float dirz,
                                               float px, float py, float fis, SurfelGeom& g) {
  const float tux = r[kTu], tuy = r[kTu + 1], tuz = r[kTu + 2];
  const float tvx = r[kTv], tvy = r[kTv + 1], tvz = r[kTv + 2];
  const float twx = r[kTw], twy = r[kTw + 1], twz = r[kTw + 2];
  const float nx = r[kNrm], ny = r[kNrm + 1], nz = r[kNrm + 2];
  g.rho_r = q.rho_r;
  g.tu_tu = q.tu_tu;
  g.tv_tv = q.tv_tv;
  const float cos2 = dot3_rn(nx, ny, nz, dirx, diry, dirz);
  g.hit = cos2 != 0.f;
  g.cos2s = g.hit ? cos2 : 1.f;
  g.lam2 = __fdiv_rn(q.lam, g.cos2s);
  g.dpx = __fadd_rn(__fmul_rn(g.lam2, dirx), -twx);
  g.dpy = __fadd_rn(__fmul_rn(g.lam2, diry), -twy);
  g.dpz = __fadd_rn(__fmul_rn(g.lam2, dirz), -twz);
  g.sx = __fdiv_rn(dot3_rn(g.dpx, g.dpy, g.dpz, tux, tuy, tuz), g.tu_tu);
  g.sy = __fdiv_rn(dot3_rn(g.dpx, g.dpy, g.dpz, tvx, tvy, tvz), g.tv_tv);
  const float rho3d = __fadd_rn(__fmul_rn(g.sx, g.sx), __fmul_rn(g.sy, g.sy));

  g.dxc = __fadd_rn(r[kCen], -px);
  g.dyc = __fadd_rn(r[kCen + 1], -py);
  const float rho2d =
      __fmul_rn(fis, __fadd_rn(__fmul_rn(__fmul_rn(40.f, g.dxc), g.dxc),
                               __fmul_rn(__fmul_rn(100.f, g.dyc), g.dyc)));

  const bool pos = g.hit && g.lam2 > 0.f;
  g.use3d = pos && rho3d <= rho2d;
  // minimum(rho3d, rho2d) that keeps a NaN rho3d, as torch.minimum does
  const float rho = pos ? (rho3d > rho2d ? rho2d : rho3d) : rho2d;
  g.depth = g.use3d ? g.lam2 : g.rho_r;
  g.power = __fmul_rn(-0.5f, rho);
}

// Everything up to `power` for the row `r` and a pixel: the row part, then
// the pair part.
__device__ __forceinline__ void surfel_pair(const float* __restrict__ r, int kCen, float dirx,
                                            float diry, float dirz, float px, float py,
                                            float fis, SurfelGeom& g) {
  SurfelRow q;
  surfel_row(r, q, g.tw_sq, g.tu_sq, g.tv_sq);
  surfel_pair_at(r, q, kCen, dirx, diry, dirz, px, py, fis, g);
}

// e, araw and alpha of a pair. NaN stays NaN and fails the caller's
// alpha >= alpha_min.
__device__ __forceinline__ void surfel_alpha(const float* __restrict__ r, float alpha_clamp,
                                             SurfelGeom& g) {
  g.e = expf(g.power);
  g.araw = __fmul_rn(r[kSOpacity], g.e);
  g.alpha = g.araw > alpha_clamp ? alpha_clamp : g.araw;
}

// The distortion map of a depth: m = far/(far-near) (1 - near / max(depth, floor)).
__device__ __forceinline__ float distortion_m(float depth, const SurfelConsts& k) {
  return k.m_scale * (1.f - k.near / fmaxf(depth, k.depth_floor));
}

}  // namespace lidargs
