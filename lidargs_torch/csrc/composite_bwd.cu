// Backward range-view composite (kernels K2 and K4) for Hopper (sm_90a).
//
// K2 replaces the TPU kernel `_bwd_kernel` / `_bwd_tile` of
// lidargs_tpu/ops/pallas_composite.py (reached through `_bwd_call` and the
// custom VJP of `composite_tiles_pallas`). Same function, the VJP of K1
// (composite_fwd.cu):
//
//   in   inst   [T, K, F] f32     depth-ordered packed instances per tile
//        counts [T]       i32     live rows per tile
//        pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
//        res    [T, 8, NPIX] f32  K1's output for these inputs
//        g      [T, 8, NPIX] f32  cotangent of that output
//   out  dinst  [T, K, F] f32     per row: d mean(3), d u1(3), d u2(3),
//                                 d conic(3), d opacity, d depth, d feat(C);
//                                 zero in the rect, center, valid and pad
//                                 columns and on every row no pixel reached
//
// Per pixel, in K1's order: TOT = sum_c gc*totc + gd*totd (from res); for
// each applied instance, behind = TOT - (running sum of w*direct, this row
// included), dalpha = P*direct - (behind + gT*Tfin) / (1 - alpha), where P
// is the transmittance before the instance; only rows with alpha below the
// clamp (live) carry dalpha into power, the conic, the basis and the mean.
// As in the TPU kernel there is no /|u|^2 (u1, u2 are unit vectors), so the
// per-row d u1, d u2 hold a radial part that the projection's normalization
// removes upstream.
//
// What bounds it on an H100. At the training configuration (T = 336 tiles,
// K = 768, F = 24, NPIX = 512) it reads inst (24.8 MB), pix, res and g
// (3 x 5.5 MB) and writes dinst (24.8 MB): ~66 MB, ~20 us at 3.35 TB/s. It
// repeats K1's walk; on the smoke scene's training step that visits ~102 M
// pixel-instance pairs outside the parity rect (~4 operations, the rect
// test), ~22 M inside it that fail a test or cross (~35, the forward's
// arithmetic) and ~7.7 M applied pairs (~80 for the recompute and the chain
// above, plus 14 + C adds to reduce each row over the tile's pixels): ~1.9 G
// operations, ~29 us at 67 TFLOP/s. So it is bound by operations. Beyond
// that, its time goes to the walk that every pixel repeats, to the chain of
// the applied pairs and to reducing each row over the tile's pixels: an SM
// retires about one warp-wide shuffle a clock, and a butterfly per column
// (80 shuffles a row) on every warp and row that any lane applied, with
// zeros stored for every other, cost ~22% of the kernel (utils/kernel_ab.py,
// against the reduction below). chip_smoke.py counts the (tile, warp, row)
// visits that reduce: 0.70 M of the ~4.1 M on its scene's training step.
// The chain runs on ~11 of a warp's 32 lanes there, and is ~35% of the
// kernel's time (kernel_ab, with the chain taken out).
//
// Design, deterministic, no atomics:
//   * one block per tile, one thread per pixel; the tile's rows are staged
//     through shared memory kBwdRows (64) at a time, with three barriers a
//     chunk;
//   * each thread repeats K1's own sequential walk (composite_common.cuh:
//     the same rect and count tests, the same expf, the same T*(1-alpha)
//     crossing rule), so it stops exactly where the forward that produced
//     `res` stopped, and carries the running sum of w*direct for `behind`;
//     the chain's one division is __fdividef (~2 ulp), which moves dinst
//     by ~1e-7 of each column's scale and the walk not at all;
//   * each row's gradient is a sum over the tile's pixels (bwd_reduce.cuh):
//     per warp, nothing where no lane applied the row, the lane's own values
//     where one did, else a 16-shuffle transpose-reduce; one partial per
//     touching warp in shared memory, marked in the warp's touched word; a
//     fixed-order sum over the touching warps, one write per element. Every
//     run gives the same bits, as the TPU kernel does;
//   * the 1024-thread bound caps it at 64 registers: 55-60 at C = 2, no
//     spills, 2 blocks of 512 threads an SM; 3 blocks (40 registers, with
//     spills) ran no faster;
//   * the block leaves once every pixel is done (__syncthreads_or), and
//     writes zeros on the rows it never reached.
//
// K4, the window form (`lidargs_composite_bwd_windows`), replaces the TPU
// kernel `_bwd_kernel_fused` (reached through `_fused_bwd_call`, then
// `mask_unwritten_rows`, in the custom VJP of `composite_windows_pallas`).
// It is K2's body reading tile t's rows from buf + starts[t] * F (as K3) and
// writing their gradients to dbuf + starts[t] * F. The TPU kernel copies a
// whole [K, F] block to each window; neighbouring windows overlap in their
// [count, K) tails, and the TPU's grid runs its tiles one at a time in
// ascending order, so a later tile's rows overwrite an earlier tile's zero
// tail. Blocks run at once here, so that copy would race. The rule instead:
// the caller zeroes dbuf, and block t writes only the rows it owns,
// [starts[t], starts[t] + count) (gradients, and zeros on the owned rows no
// pixel reached), and nothing in [count, K). Owned ranges are disjoint,
// since starts[t+1] >= starts[t] + count, so there are no atomics, every run
// gives the same bits, and each owned row equals K2's row on the same
// inputs. Every other row stays zero: that is the TPU's dbuf after
// `mask_unwritten_rows`.
#include <cuda_runtime.h>

#include "bwd_reduce.cuh"
#include "composite_common.cuh"

using namespace lidargs;

namespace {

// kWindows: tile t's rows (and their gradients) start at row starts[t] of
// inst (dinst), and only its [0, count) rows are written (K4); else at row
// t * K, all K written (K2; starts is not read).
template <int C, bool kWindows>
__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, const float* __restrict__ res,
    const float* __restrict__ g, float* __restrict__ dinst, int K, int F, int npix,
    float alpha_min, float alpha_clamp, float t_min) {
  constexpr int NV = kFeat0 + C;      // gradient columns per row
  constexpr int NP = (NV + 3) / 4 * 4;  // their stride in the partials: whole float4s
  constexpr int kRect = kFeat0 + C;
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);           // [kBwdRows][F]
  float* part = rows + kBwdRows * F;                       // [n_warps][kBwdRows][NP]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5, n_warps = blockDim.x >> 5;
  RowBits* touched = reinterpret_cast<RowBits*>(part + n_warps * kBwdRows * NP);  // [n_warps]
  const bool in = p < npix;           // the block is padded to whole warps

  float dirx = 0.f, diry = 0.f, dirz = 0.f, px = 0.f, py = 0.f;
  float gc[C], gd = 0.f, gT = 0.f, tot = 0.f, t_fin = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = 0.f;
  if (in) {
    const size_t o = (size_t)t * kOutRows * npix + p;
    dirx = pix[o];
    diry = pix[o + npix];
    dirz = pix[o + 2 * npix];
    px = pix[o + 3 * npix];
    py = pix[o + 4 * npix];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gc[c] = g[o + c * npix];
      tot += gc[c] * res[o + c * npix];
    }
    gd = g[o + C * npix];
    gT = g[o + (C + 1) * npix];
    tot += gd * res[o + C * npix];
    t_fin = res[o + (C + 1) * npix];
  }

  const int count = min(max(counts[t], 0), K);
  const size_t row0 = kWindows ? (size_t)starts[t] * F : (size_t)t * K * F;
  const float* ti = inst + row0;
  float* to = dinst + row0;
  float T = 1.f;
  float acc_w = 0.f;                  // running sum of w * direct
  bool done = !in;
  int reached = 0;                    // rows [0, reached) are written

  for (int base = 0; base < count; base += kBwdRows) {
    const int n = min(kBwdRows, count - base);
    __syncthreads();                  // previous chunk's rows, partials and words consumed
    for (int i = p; i < n * F; i += blockDim.x) rows[i] = ti[(size_t)base * F + i];
    __syncthreads();
    RowBits mine = 0;                // bit j: this warp stored a partial of row j
    for (int j = 0; j < n; ++j) {     // every lane runs every j: the warp votes below
      const float* r = rows + j * F;
      float v[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) v[k] = 0.f;
      bool hit = false;
      PairGeom gm;
      bool passed = false;
      if (!done && px >= r[kRect] && px < r[kRect + 1] && py >= r[kRect + 2] &&
          py < r[kRect + 3]) {
        pair_power(r, dirx, diry, dirz, gm);
        if (gm.power <= 0.f) {
          pair_alpha(r, alpha_clamp, gm);
          passed = gm.alpha >= alpha_min;
        }
      }
      if (passed) {
        const float T_next = transmit(T, gm.alpha);
        if (T_next < t_min) {
          done = true;                // crossing: not applied, pixel done
        } else {
          hit = true;
          const float P = T;
          const float w = gm.alpha * P;
          T = T_next;
          float direct = gd * r[kDepth];
#pragma unroll
          for (int c = 0; c < C; ++c) direct += gc[c] * r[kFeat0 + c];
          acc_w += w * direct;
          const float behind = tot - acc_w;
          if (gm.araw <= alpha_clamp) {      // live: alpha is not clamped
            const float dalpha = P * direct - __fdividef(behind + gT * t_fin, 1.f - gm.alpha);
            const float dpower = dalpha * gm.araw;
            const float a = r[kConic], b = r[kConic + 1], cc = r[kConic + 2];
            const float d_ddx = -dpower * (a * gm.ddx + b * gm.ddy);
            const float d_ddy = -dpower * (cc * gm.ddy + b * gm.ddx);
            v[0] = d_ddx * r[kU1] + d_ddy * r[kU2];
            v[1] = d_ddx * r[kU1 + 1] + d_ddy * r[kU2 + 1];
            v[2] = d_ddx * r[kU1 + 2] + d_ddy * r[kU2 + 2];
            v[3] = d_ddx * gm.dx;
            v[4] = d_ddx * gm.dy;
            v[5] = d_ddx * gm.dz;
            v[6] = d_ddy * gm.dx;
            v[7] = d_ddy * gm.dy;
            v[8] = d_ddy * gm.dz;
            v[9] = -0.5f * gm.ddx * gm.ddx * dpower;
            v[10] = -gm.ddx * gm.ddy * dpower;
            v[11] = -0.5f * gm.ddy * gm.ddy * dpower;
            v[12] = dalpha * gm.e;
          }
          v[13] = w * gd;
#pragma unroll
          for (int c = 0; c < C; ++c) v[kFeat0 + c] = w * gc[c];
        }
      }
      const unsigned hits = __ballot_sync(kFullMask, hit);
      if (hits) {
        store_warp_sum<NV, NP, -1>(v, hits, lane, part + (warp * kBwdRows + j) * NP);
        mine |= RowBits(1) << j;
      }
    }
    if (lane == 0) touched[warp] = mine;
    __syncthreads();                  // partials and touched words of this chunk complete
    write_chunk<NV, NP, -1>(part, touched, n, F, n_warps, warp, lane, to + (size_t)base * F);
    reached = base + n;
    if (!__syncthreads_or(!done)) break;   // every pixel has crossed
  }

  const int owned = kWindows ? count : K;   // K4 writes nothing in [count, K)
  for (size_t i = (size_t)reached * F + p; i < (size_t)owned * F; i += blockDim.x) to[i] = 0.f;
}

template <int C, bool kWindows>
cudaError_t launch_as(const float* inst, const int* starts, const int* counts,
                      const float* pix, const float* res, const float* g, float* dinst, int T,
                      int K, int F, int npix, float alpha_min, float alpha_clamp, float t_min,
                      cudaStream_t stream) {
  const int threads = (npix + 31) / 32 * 32;
  constexpr int NP = (kFeat0 + C + 3) / 4 * 4;
  const int n_warps = threads / 32;
  const size_t smem =
      ((size_t)kBwdRows * F + (size_t)n_warps * kBwdRows * NP) * sizeof(float) +
      n_warps * sizeof(RowBits);
  cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel<C, kWindows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<C, kWindows><<<T, threads, smem, stream>>>(
      inst, starts, counts, pix, res, g, dinst, K, F, npix, alpha_min, alpha_clamp, t_min);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const float* inst, const int* starts, const int* counts, const float* pix,
                   const float* res, const float* g, float* dinst, int T, int K, int F,
                   int npix, float alpha_min, float alpha_clamp, float t_min,
                   cudaStream_t stream) {
  return starts ? launch_as<C, true>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix,
                                     alpha_min, alpha_clamp, t_min, stream)
                : launch_as<C, false>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix,
                                      alpha_min, alpha_clamp, t_min, stream);
}

// K2 where starts is null, K4 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             const float* res, const float* g, float* dinst, int T, int K, int F, int npix,
             int C, float alpha_min, float alpha_clamp, float t_min, void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kFeat0 + C + 4 || C < 1 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 2: return (int)launch<2>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 3: return (int)launch<3>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 4: return (int)launch<4>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 5: return (int)launch<5>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    default: return (int)launch<6>(inst, starts, counts, pix, res, g, dinst, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller has checked shapes, types, contiguity and the device.
int lidargs_composite_bwd(const float* inst, const int* counts, const float* pix,
                          const float* res, const float* g, float* dinst, int T, int K,
                          int F, int npix, int C, float alpha_min, float alpha_clamp,
                          float t_min, void* stream) {
  return dispatch(inst, nullptr, counts, pix, res, g, dinst, T, K, F, npix, C, alpha_min,
                  alpha_clamp, t_min, stream);
}

// Launches K4 on `stream`: the VJP of K3, writing the gradient of each
// tile's rows [starts[t], starts[t] + min(counts[t], K)) into dbuf [E, F],
// which the caller has zeroed, and no other row. The caller has checked
// shapes, types, contiguity and the device, and that every window lies
// inside buf.
int lidargs_composite_bwd_windows(const float* buf, const int* starts, const int* counts,
                                  const float* pix, const float* res, const float* g,
                                  float* dbuf, int T, int K, int F, int npix, int C,
                                  float alpha_min, float alpha_clamp, float t_min,
                                  void* stream) {
  return dispatch(buf, starts, counts, pix, res, g, dbuf, T, K, F, npix, C, alpha_min,
                  alpha_clamp, t_min, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
