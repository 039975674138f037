// Backward surfel (2DGS) composite (kernels K6 and K8) for Hopper (sm_90a).
//
// K6 replaces the TPU kernel `_bwd_kernel` / `_bwd_tile` of
// lidargs_tpu/ops/pallas_surfel.py (reached through `_bwd_call` and the
// custom VJP of its `surfel_composite_tiles`). Same function, the VJP of K5
// (surfel_fwd.cu):
//
//   in   inst   [T, K, F] f32      depth-ordered packed surfels per tile
//        counts [T]       i32      live rows per tile
//        pix    [T, 8, NPIX] f32   rows 0-2 unit ray dir, row 3 column, row 4 row
//        res    [T, 16, NPIX] f32  K5's output for these inputs
//        g      [T, 16, NPIX] f32  cotangent of that output (all C+9 rows)
//   out  dinst  [T, K, F] f32      per row: d Tu(3), d Tv(3), d Tw(3),
//                                  d normal(3), d opacity, 0 at DEPTH,
//                                  d feat(C), d center(2); zero in the rect,
//                                  valid and pad columns and on every row no
//                                  pixel reached
//
// Per pixel, in K5's order, one pass (the TPU kernel's closed forms): with
// P the transmittance before an applied surfel, w = alpha P, m its depth's
// distortion map and M1, M2 the running sums of w m, w m^2 before it,
//   psi    = m^2 (1 - P) + M2 - 2 m M1        (its own distortion term)
//   S      = m^2 W_after - 2 m M1_after + M2_after, the pairs behind it, each
//            "after" a total from res (1 - T_fin, M1, M2) minus the prefix
//   direct = gc.feat + gd depth + gn.n + gdist (psi + S) + gm1 m + gm2 m^2
//   behind = TOT - (running sum of w direct, this row included), where TOT
//            sums every row's cotangent times its total, the distortion's
//            twice (sum_i w_i S_i equals the distortion itself)
//   dalpha = P direct - (behind + gT T_fin) / (1 - alpha)   (alpha unclamped)
//   d depth = gd w + dm/ddepth (gdist 2 w (m W_tot - M1_tot) + gm1 w + gm2 2 w m)
//             + g_median where P > 0.5 and depth == K5's saved median;
// then dalpha through alpha = op exp(-rho/2) into the opacity and rho, rho
// into the plane coordinates (Tu, Tv, the intersection point) where the
// plane's value was taken and into the center otherwise (rho2d), and the
// depth through lambda2 = (Tw . n) / (dir . n) or the center range |Tw|.
//
// What bounds it on an H100. At the surfel training configuration (T = 1344
// tiles, K = 384, F = 24, NPIX = 128) the function reads at most 45.4 MB
// of inst (the 22 columns up to the valid flag but DEPTH), the five pixel
// rows it uses (3.4 MB) and rows 0..C+8 of res and g (2 x 7.6 MB), and
// writes dinst (49.5 MB): ~113 MB, ~34 us at 3.35 TB/s. It repeats K5's
// walk; each applied pair adds the chain above (~190 operations) and one add
// per gradient column (16 + C) to reduce its row over the tile's pixels. The
// count of pairs depends on the data; chip_smoke.py counts it from each
// run's inputs, and the (tile, warp, row) visits that reduce. On its
// full-width scene the bytes bound it; the time goes to the walk, the chain
// and the row reduction, as in K2.
//
// Design, deterministic, no atomics, as K2 (composite_bwd.cu):
//   * one block per tile, one thread per pixel; the tile's rows are staged
//     through shared memory kBwdRows (64) at a time;
//   * each thread repeats K5's own sequential walk (surfel_common.cuh: the
//     same tests, the same roundings, the same crossing rule), so it stops
//     where the forward that produced `res` stopped and recomputes each
//     pair's depth with the bits K5 compared with its median; the chain's
//     divisions are reciprocals and __fdividef (~2 ulp), which move dinst by
//     ~5e-5 of a column's scale at most and the walk not at all;
//   * each row's gradient is a sum over the tile's pixels (bwd_reduce.cuh):
//     per warp, nothing where no lane applied the row, the lane's own values
//     where one did, else a transpose-reduce of 16 of the 17 live columns
//     (the DEPTH column gets no gradient) and one butterfly; one partial per
//     touching warp, a fixed-order sum over the touching warps, one write per
//     element, so every run gives the same bits, as the TPU kernel does;
//   * tiles of up to 128 pixels (the surfel tiling, h1) run the instance
//     bounded at 128 threads and kMinBlocks (6) blocks an SM: 80 registers
//     at C = 2 and no spills, where the 1024-thread bound capped the chain
//     at 64 with ~140 bytes of spills; wider tiles run the 1024-thread
//     instance;
//   * the block leaves once every pixel is done (__syncthreads_or), and
//     writes zeros on the rows it never reached.
//
// K8, the window form (`lidargs_surfel_bwd_windows`), replaces the TPU
// kernel `_bwd_kernel_fused` of pallas_surfel.py (reached through its
// `_fused_bwd_call`, then `mask_unwritten_rows`, in the custom VJP of
// `surfel_composite_windows`). It is K6's body reading tile t's rows from
// buf + starts[t] * F and writing their gradients to dbuf + starts[t] * F,
// under K4's write rule (composite_bwd.cu): the caller zeroes dbuf, block t
// writes only its owned rows [starts[t], starts[t] + count) and nothing in
// [count, K), so the TPU's in-order overwrite of overlapping window tails
// needs no counterpart, no row is written twice, and each owned row equals
// K6's row on the same inputs. It replays K5's walk through the same
// surfel_common.cuh, so the median's cotangent finds the same row.
#include <cuda_runtime.h>

#include "bwd_reduce.cuh"
#include "surfel_common.cuh"

using namespace lidargs;

namespace {

constexpr int kMinBlocks = 6;      // blocks an SM for tiles of <= 128 pixels: <= 80 registers

// kWindows: tile t's rows (and their gradients) start at row starts[t] of
// inst (dinst), and only its [0, count) rows are written (K8); else at row
// t * K, all K written (K6; starts is not read). A launch has at most
// kMaxThreads threads, and the compiler keeps room for kMin blocks an SM.
template <int C, bool kWindows, int kMaxThreads, int kMin>
__global__ void __launch_bounds__(kMaxThreads, kMin) surfel_bwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, const float* __restrict__ res,
    const float* __restrict__ g, float* __restrict__ dinst, int K, int F, int npix,
    SurfelConsts kc) {
  constexpr int NV = kSFeat0 + C + 2;   // gradient columns per row, through the center
  constexpr int NP = (NV + 3) / 4 * 4;  // their stride in the partials: whole float4s
  constexpr int kCen = kSFeat0 + C, kRect = kCen + 2, kValid = kCen + 6;
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);           // [kBwdRows][F]
  float* part = rows + kBwdRows * F;                       // [n_warps][kBwdRows][NP]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5, n_warps = blockDim.x >> 5;
  RowBits* touched = reinterpret_cast<RowBits*>(part + n_warps * kBwdRows * NP);  // [n_warps]
  const bool in = p < npix;             // the block is padded to whole warps

  float dirx = 0.f, diry = 0.f, dirz = 0.f, px = 0.f, py = 0.f;
  float gc[C], gn[3] = {0.f, 0.f, 0.f};
  float gd = 0.f, gT = 0.f, gmed = 0.f, gdist = 0.f, gm1 = 0.f, gm2 = 0.f;
  float tot = 0.f, t_fin = 1.f, med = 0.f, totm1 = 0.f, totm2 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = 0.f;
  if (in) {
    const float* tp = pix + (size_t)t * kPixRows * npix + p;
    dirx = tp[0];
    diry = tp[npix];
    dirz = tp[2 * npix];
    px = tp[3 * npix];
    py = tp[4 * npix];
    const size_t o = (size_t)t * kSurfelOutRows * npix + p;
    const float* rr = res + o;
    const float* gg = g + o;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gc[c] = gg[c * npix];
      tot += gc[c] * rr[c * npix];
    }
    gd = gg[C * npix];
    gT = gg[(C + 1) * npix];
    tot += gd * rr[C * npix];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gn[k] = gg[(C + 2 + k) * npix];
      tot += gn[k] * rr[(C + 2 + k) * npix];
    }
    gmed = gg[(C + 5) * npix];
    gdist = gg[(C + 6) * npix];
    gm1 = gg[(C + 7) * npix];
    gm2 = gg[(C + 8) * npix];
    t_fin = rr[(C + 1) * npix];
    med = rr[(C + 5) * npix];
    totm1 = rr[(C + 7) * npix];
    totm2 = rr[(C + 8) * npix];
    tot += gdist * 2.f * rr[(C + 6) * npix] + gm1 * totm1 + gm2 * totm2;
  }
  const float w_tot = 1.f - t_fin;

  const int count = min(max(counts[t], 0), K);
  const size_t row0 = kWindows ? (size_t)starts[t] * F : (size_t)t * K * F;
  const float* ti = inst + row0;
  float* to = dinst + row0;
  float T = 1.f;
  float acc_w = 0.f;                    // running sum of w * direct
  float am1 = 0.f, am2 = 0.f;           // running sums of w m, w m^2
  bool done = !in;
  int reached = 0;                      // rows [0, reached) are written

  for (int base = 0; base < count; base += kBwdRows) {
    const int n = min(kBwdRows, count - base);
    __syncthreads();                    // previous chunk's rows, partials and words consumed
    for (int i = p; i < n * F; i += blockDim.x) rows[i] = ti[(size_t)base * F + i];
    __syncthreads();
    RowBits mine = 0;                  // bit j: this warp stored a partial of row j
    for (int j = 0; j < n; ++j) {       // every lane runs every j: the warp votes below
      const float* r = rows + j * F;
      float v[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) v[k] = 0.f;
      bool hit = false;
      SurfelGeom gm;
      bool passed = false;
      if (!done && r[kValid] > 0.f && px >= r[kRect] && px < r[kRect + 1] &&
          py >= r[kRect + 2] && py < r[kRect + 3]) {
        surfel_pair(r, kCen, dirx, diry, dirz, px, py, kc.fis, gm);
        if (gm.hit && gm.depth >= kc.near && gm.power <= 0.f) {
          surfel_alpha(r, kc.alpha_clamp, gm);
          passed = gm.alpha >= kc.alpha_min;
        }
      }
      if (passed) {
        const float T_next = transmit(T, gm.alpha);
        if (T_next < kc.t_min) {
          done = true;                  // crossing: not applied, pixel done
        } else {
          hit = true;
          const float P = T;
          const float w = gm.alpha * P;
          T = T_next;
          const float dep = gm.depth;
          const float m = distortion_m(dep, kc);
          const float wm = w * m, wm2 = wm * m;
          const float psi = m * m * (1.f - P) + am2 - 2.f * m * am1;
          const float s_k = m * m * (P - w - t_fin) - 2.f * m * (totm1 - am1 - wm) +
                            (totm2 - am2 - wm2);
          float direct = gd * dep + gdist * (psi + s_k) + gm1 * m + gm2 * m * m;
#pragma unroll
          for (int c = 0; c < C; ++c) direct += gc[c] * r[kSFeat0 + c];
#pragma unroll
          for (int k = 0; k < 3; ++k) direct += gn[k] * r[kNrm + k];
          acc_w += w * direct;
          am1 += wm;
          am2 += wm2;
          const float behind = tot - acc_w;
          const float dalpha = gm.araw <= kc.alpha_clamp      // live: alpha is not clamped
              ? P * direct - __fdividef(behind + gT * t_fin, 1.f - gm.alpha) : 0.f;

          // the value chains: the distortion map m, the depth, the median
          const float d_m = gdist * 2.f * w * (m * w_tot - totm1) + gm1 * w + gm2 * 2.f * wm;
          const float dm_ddep = dep > kc.depth_floor ? __fdividef(kc.m_dscale, dep * dep) : 0.f;
          float d_dep = gd * w + d_m * dm_ddep;
          if (P > 0.5f && dep == med) d_dep += gmed;

          // alpha = min(clamp, op e), e = exp(-rho / 2)
          const float drho = -0.5f * dalpha * gm.araw;
          const float drho3d = gm.use3d ? drho : 0.f;
          const float drho2d = gm.use3d ? 0.f : drho;
          // rho2d = fis (40 dxc^2 + 100 dyc^2), dxc = center column - pixel column
          v[kCen] = kc.fis * 80.f * gm.dxc * drho2d;
          v[kCen + 1] = kc.fis * 200.f * gm.dyc * drho2d;
          // rho3d = sx^2 + sy^2, sx = (dp . Tu) / max(|Tu|^2, eps): the radial
          // term dies where the clamp is active, as autodiff of max
          const float dsx = 2.f * gm.sx * drho3d, dsy = 2.f * gm.sy * drho3d;
          const float itu = __fdividef(1.f, gm.tu_tu), itv = __fdividef(1.f, gm.tv_tv),
                      icos = __fdividef(1.f, gm.cos2s);
          const float ncu = gm.tu_sq > 1e-20f ? 1.f : 0.f;
          const float ncv = gm.tv_sq > 1e-20f ? 1.f : 0.f;
          const float dp[3] = {gm.dpx, gm.dpy, gm.dpz};
          const float dir[3] = {dirx, diry, dirz};
          float ddp[3];
          float d_lam2 = gm.use3d ? d_dep : 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float tu = r[kTu + a], tv = r[kTv + a];
            ddp[a] = dsx * tu * itu + dsy * tv * itv;
            v[kTu + a] = dsx * (dp[a] - ncu * 2.f * gm.sx * tu) * itu;
            v[kTv + a] = dsy * (dp[a] - ncv * 2.f * gm.sy * tv) * itv;
            d_lam2 += ddp[a] * dir[a];
          }
          // depth = use3d ? lam2 : rho_r; dp = lam2 dir - Tw; lam2 = (Tw . n) / cos2
          const float d_rho_r = gm.use3d ? 0.f : d_dep;
          const float d_lam = d_lam2 * icos;
          const float d_cos2 = -d_lam2 * gm.lam2 * icos;   // applied rows hit the plane
          const float rr_fac = gm.tw_sq > 1e-20f ? __fdividef(d_rho_r, gm.rho_r) : 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float tw = r[kTw + a], nrm = r[kNrm + a];
            v[kTw + a] = -ddp[a] + d_lam * nrm + rr_fac * tw;
            v[kNrm + a] = d_lam * tw + d_cos2 * dir[a] + w * gn[a];
          }
          v[kSOpacity] = dalpha * gm.e;
#pragma unroll
          for (int c = 0; c < C; ++c) v[kSFeat0 + c] = w * gc[c];
        }
      }
      const unsigned hits = __ballot_sync(kFullMask, hit);
      if (hits) {
        store_warp_sum<NV, NP, kSDepth>(v, hits, lane, part + (warp * kBwdRows + j) * NP);
        mine |= RowBits(1) << j;
      }
    }
    if (lane == 0) touched[warp] = mine;
    __syncthreads();                    // partials and touched words of this chunk complete
    write_chunk<NV, NP, kSDepth>(part, touched, n, F, n_warps, warp, lane,
                                 to + (size_t)base * F);
    reached = base + n;
    if (!__syncthreads_or(!done)) break;   // every pixel has crossed
  }

  const int owned = kWindows ? count : K;   // K8 writes nothing in [count, K)
  for (size_t i = (size_t)reached * F + p; i < (size_t)owned * F; i += blockDim.x) to[i] = 0.f;
}

template <int C, bool kWindows, int kMaxThreads, int kMin>
cudaError_t launch_as(const float* inst, const int* starts, const int* counts,
                      const float* pix, const float* res, const float* g, float* dinst, int T,
                      int K, int F, int npix, const SurfelConsts& kc, cudaStream_t stream) {
  constexpr int NP = (kSFeat0 + C + 2 + 3) / 4 * 4;
  const int threads = (npix + 31) / 32 * 32;
  const int n_warps = threads / 32;
  const size_t smem =
      ((size_t)kBwdRows * F + (size_t)n_warps * kBwdRows * NP) * sizeof(float) +
      n_warps * sizeof(RowBits);
  cudaError_t err = cudaFuncSetAttribute(surfel_bwd_kernel<C, kWindows, kMaxThreads, kMin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  surfel_bwd_kernel<C, kWindows, kMaxThreads, kMin><<<T, threads, smem, stream>>>(
      inst, starts, counts, pix, res, g, dinst, K, F, npix, kc);
  return cudaGetLastError();
}

// The instance bounded at 128 threads where the tile has 128 pixels or
// fewer, else the one bounded at 1024.
template <int C, bool kWindows>
cudaError_t launch_sized(const float* inst, const int* starts, const int* counts,
                         const float* pix, const float* res, const float* g, float* dinst,
                         int T, int K, int F, int npix, const SurfelConsts& kc,
                         cudaStream_t stream) {
  return npix <= 128
      ? launch_as<C, kWindows, 128, kMinBlocks>(inst, starts, counts, pix, res, g, dinst, T, K,
                                                F, npix, kc, stream)
      : launch_as<C, kWindows, 1024, 1>(inst, starts, counts, pix, res, g, dinst, T, K, F,
                                        npix, kc, stream);
}

template <int C>
cudaError_t launch(const float* inst, const int* starts, const int* counts, const float* pix,
                   const float* res, const float* g, float* dinst, int T, int K, int F,
                   int npix, const SurfelConsts& kc, cudaStream_t stream) {
  return starts ? launch_sized<C, true>(inst, starts, counts, pix, res, g, dinst, T, K, F,
                                        npix, kc, stream)
                : launch_sized<C, false>(inst, starts, counts, pix, res, g, dinst, T, K, F,
                                         npix, kc, stream);
}

// K6 where starts is null, K8 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             const float* res, const float* g, float* dinst, int T, int K, int F, int npix,
             int C, const SurfelConsts& kc, void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kSFeat0 + C + 7 || C < 1 || C > kSurfelMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    case 2: return (int)launch<2>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    case 3: return (int)launch<3>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    case 4: return (int)launch<4>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    case 5: return (int)launch<5>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    case 6: return (int)launch<6>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
    default: return (int)launch<7>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, kc, s);
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller has checked shapes, types, contiguity and the device.
int lidargs_surfel_bwd(const float* inst, const int* counts, const float* pix,
                       const float* res, const float* g, float* dinst, int T, int K, int F,
                       int npix, int C, float alpha_min, float alpha_clamp, float t_min,
                       float near, float fis, float m_scale, float m_dscale,
                       float depth_floor, void* stream) {
  const SurfelConsts kc{alpha_min, alpha_clamp, t_min, near, fis, m_scale, m_dscale,
                        depth_floor};
  return dispatch(inst, nullptr, counts, pix, res, g, dinst, T, K, F, npix, C, kc, stream);
}

// Launches K8 on `stream`: the VJP of K7, writing the gradient of each
// tile's rows [starts[t], starts[t] + min(counts[t], K)) into dbuf [E, F],
// which the caller has zeroed, and no other row. The caller has checked
// shapes, types, contiguity and the device, and that every window lies
// inside buf.
int lidargs_surfel_bwd_windows(const float* buf, const int* starts, const int* counts,
                               const float* pix, const float* res, const float* g,
                               float* dbuf, int T, int K, int F, int npix, int C,
                               float alpha_min, float alpha_clamp, float t_min, float near,
                               float fis, float m_scale, float m_dscale, float depth_floor,
                               void* stream) {
  const SurfelConsts kc{alpha_min, alpha_clamp, t_min, near, fis, m_scale, m_dscale,
                        depth_floor};
  return dispatch(buf, starts, counts, pix, res, g, dbuf, T, K, F, npix, C, kc, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
