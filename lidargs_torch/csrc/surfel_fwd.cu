// Forward surfel (2DGS) composite (kernels K5 and K7) for Hopper (sm_90a).
//
// K5 replaces the TPU kernel `_fwd_kernel` / `_fwd_tile` (with `_surfel_alpha`)
// of lidargs_tpu/ops/pallas_surfel.py, reached through its
// `surfel_composite_tiles`. Same function:
//
//   in   inst   [T, K, F] f32     depth-ordered packed surfels per tile
//                                 (SurfelCols, lidargs_torch/ops/surfel.py)
//        counts [T]       i32     live rows per tile (rows >= count are ignored)
//        pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
//   out         [T, 16, NPIX] f32 rows 0..C-1 features, C depth, C+1 final
//                                 transmittance, C+2..C+4 normal, C+5 median
//                                 depth, C+6 distortion, C+7 M1, C+8 M2, the
//                                 rest 0
//
// Per pixel and surfel (surfel_common.cuh): the ray's intersection with the
// surfel plane, lambda2 = (Tw . n) / (dir . n), its plane coordinates sx, sy
// and rho3d = sx^2 + sy^2 against the low-pass rho2d around the projected
// center; depth = lambda2 where the plane's value is taken, else the center
// range; alpha = min(op * exp(-rho / 2), alpha_clamp). The surfel passes iff
// it is valid, inside the count and its parity rect, the ray hits the plane,
// depth >= surfel_near and alpha >= alpha_min. Front to back, the walk stops
// at the first passed surfel with T * (1 - alpha) < transmittance_min, and
// that surfel is not applied (K1's rule). Each applied surfel adds w = alpha T
// to the features, the depth and the normal; the distortion adds
// w (m^2 (1 - T) + M2 - 2 m M1) with the running M1 = sum w m, M2 = sum w m^2
// (m the depth's distortion map); the median depth is the depth of the last
// applied surfel whose T before it is > 0.5. M1 and M2 are written out: K6
// takes its "behind" sums of the distortion as these totals minus its
// running prefix.
//
// What bounds it on an H100. At the surfel training configuration (T = 1344
// tiles of 1x128 pixels, K = 384, F = 24) the function reads at most
// 1344*384*22*4 B = 45.4 MB of surfels (the 22 columns up to the valid flag
// but DEPTH) plus the five pixel rows it uses (3.4 MB) and writes 11 MB:
// ~18 us at 3.35 TB/s. A pair outside the parity rect costs the valid and
// rect tests (~5 operations); inside it ~85 FP32 operations (five 3-dot
// products, two divisions, the quadratic forms, expf, the tests) and, where
// applied, ~30 more for the accumulators. What the walk visits depends on the
// data; chip_smoke.py counts it from each run's inputs. On its full-width
// scene the bytes bound it, with the operations close behind; the early exit
// lowers both to what the data needs.
//
// Design, simple first, as K1:
//   * one block per tile, one thread per pixel (128 threads at tile_h = 1);
//   * the tile's rows are staged through shared memory kChunk at a time and
//     read by all threads as broadcasts;
//   * each thread walks the rows in depth order, testing the valid flag and
//     the rect before the geometry and the expf;
//   * the block stops staging rows once every pixel has crossed the
//     transmittance threshold (__syncthreads_or on "not done").
// The TPU kernel's Hillis-Steele prefix products and sums over sublanes
// served the TPU's layout and are not carried over: a thread multiplies T
// and sums M1, M2 in sequence.
//
// K7, the window form (`lidargs_surfel_fwd_windows`), replaces the TPU
// kernel `_fwd_kernel_fused` of pallas_surfel.py (reached through its
// `_fused_fwd_call` and `surfel_composite_windows`). It is K5's body with
// one change, as K3 is K1's (composite_fwd.cu): tile t reads its rows from
// buf + starts[t] * F, a window of one dense depth-sorted buffer [E + K, F]
// with K zero rows of padding. One template serves both, so K7 gives K5's
// bits on the same rows, the median's included.
#include <cuda_runtime.h>

#include "surfel_common.cuh"

using namespace lidargs;

namespace {

constexpr int kChunk = 64;     // surfel rows staged per shared-memory chunk

// kWindows: tile t's rows start at inst + starts[t] * F (K7), else at
// inst + t * K * F (K5; starts is not read).
template <int C, bool kWindows>
__global__ void __launch_bounds__(1024) surfel_fwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, float* __restrict__ out, int K, int F, int npix,
    SurfelConsts kc) {
  extern __shared__ float rows[];   // [kChunk][F]
  constexpr int kCen = kSFeat0 + C, kRect = kCen + 2, kValid = kCen + 6;
  const int t = blockIdx.x;
  const int p = threadIdx.x;

  const float* tp = pix + (size_t)t * kPixRows * npix;
  const float dirx = tp[p], diry = tp[npix + p], dirz = tp[2 * npix + p];
  const float px = tp[3 * npix + p], py = tp[4 * npix + p];
  const int count = min(max(counts[t], 0), K);
  const float* ti = inst + (kWindows ? (size_t)starts[t] * F : (size_t)t * K * F);

  float T = 1.f, dep = 0.f, med = 0.f, dist = 0.f, m1 = 0.f, m2 = 0.f;
  float acc[C], nrm[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  bool done = false;

  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();                                  // previous chunk consumed
    for (int i = p; i < n * F; i += blockDim.x) rows[i] = ti[(size_t)base * F + i];
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float* r = rows + j * F;
        if (!(r[kValid] > 0.f)) continue;
        if (!(px >= r[kRect] && px < r[kRect + 1] && py >= r[kRect + 2] &&
              py < r[kRect + 3]))
          continue;
        SurfelGeom g;
        surfel_pair(r, kCen, dirx, diry, dirz, px, py, kc.fis, g);
        if (!(g.hit && g.depth >= kc.near && g.power <= 0.f)) continue;
        surfel_alpha(r, kc.alpha_clamp, g);
        if (!(g.alpha >= kc.alpha_min)) continue;
        const float T_next = transmit(T, g.alpha);
        if (T_next < kc.t_min) {        // crossing: not applied, pixel done
          done = true;
          break;
        }
        const float w = g.alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * r[kSFeat0 + c];
        dep += w * g.depth;
#pragma unroll
        for (int k = 0; k < 3; ++k) nrm[k] += w * r[kNrm + k];
        const float m = distortion_m(g.depth, kc);
        const float wm = w * m;
        dist += w * (m * m * (1.f - T) + m2 - 2.f * m * m1);
        m1 += wm;
        m2 += wm * m;
        if (T > 0.5f) med = g.depth;    // the last applied row with T-before > 0.5
        T = T_next;
      }
    }
    if (!__syncthreads_or(!done)) break;             // every pixel has crossed
  }

  float* to = out + (size_t)t * kSurfelOutRows * npix + p;
#pragma unroll
  for (int c = 0; c < C; ++c) to[c * npix] = acc[c];
  to[C * npix] = dep;
  to[(C + 1) * npix] = T;
#pragma unroll
  for (int k = 0; k < 3; ++k) to[(C + 2 + k) * npix] = nrm[k];
  to[(C + 5) * npix] = med;
  to[(C + 6) * npix] = dist;
  to[(C + 7) * npix] = m1;
  to[(C + 8) * npix] = m2;
  for (int rr = C + 9; rr < kSurfelOutRows; ++rr) to[rr * npix] = 0.f;
}

template <int C>
cudaError_t launch(const float* inst, const int* starts, const int* counts, const float* pix,
                   float* out, int T, int K, int F, int npix, const SurfelConsts& kc,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * F * sizeof(float);
  if (starts)
    surfel_fwd_kernel<C, true><<<T, npix, smem, stream>>>(inst, starts, counts, pix, out, K, F,
                                                           npix, kc);
  else
    surfel_fwd_kernel<C, false><<<T, npix, smem, stream>>>(inst, starts, counts, pix, out, K,
                                                            F, npix, kc);
  return cudaGetLastError();
}

// K5 where starts is null, K7 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             float* out, int T, int K, int F, int npix, int C, const SurfelConsts& kc,
             void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kSFeat0 + C + 7 || C < 1 || C > kSurfelMaxC ||
      (size_t)kChunk * F * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    case 2: return (int)launch<2>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    case 3: return (int)launch<3>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    case 4: return (int)launch<4>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    case 5: return (int)launch<5>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    case 6: return (int)launch<6>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
    default: return (int)launch<7>(inst, starts, counts, pix, out, T, K, F, npix, kc, s);
  }
}

}  // namespace

extern "C" {

// Launches K5 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller has checked shapes, types, contiguity and the device.
int lidargs_surfel_fwd(const float* inst, const int* counts, const float* pix, float* out,
                       int T, int K, int F, int npix, int C, float alpha_min,
                       float alpha_clamp, float t_min, float near, float fis, float m_scale,
                       float m_dscale, float depth_floor, void* stream) {
  const SurfelConsts kc{alpha_min, alpha_clamp, t_min, near, fis, m_scale, m_dscale,
                        depth_floor};
  return dispatch(inst, nullptr, counts, pix, out, T, K, F, npix, C, kc, stream);
}

// Launches K7 on `stream`: tile t composites rows [starts[t], starts[t] +
// min(counts[t], K)) of buf [E, F]. The caller has checked shapes, types,
// contiguity and the device, and that every window lies inside buf.
int lidargs_surfel_fwd_windows(const float* buf, const int* starts, const int* counts,
                               const float* pix, float* out, int T, int K, int F, int npix,
                               int C, float alpha_min, float alpha_clamp, float t_min,
                               float near, float fis, float m_scale, float m_dscale,
                               float depth_floor, void* stream) {
  const SurfelConsts kc{alpha_min, alpha_clamp, t_min, near, fis, m_scale, m_dscale,
                        depth_floor};
  return dispatch(buf, starts, counts, pix, out, T, K, F, npix, C, kc, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
