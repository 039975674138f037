// Forward range-view composite (kernels K1 and K3) for Hopper (sm_90a).
//
// K1 replaces the TPU kernel `_fwd_kernel` of lidargs_tpu/ops/pallas_composite.py
// (reached through `_fwd_call` and `composite_tiles_pallas`). Same function:
//
//   in   inst   [T, K, F] f32  depth-ordered packed instances per tile
//                              (PackedCols layout, lidargs_torch/ops/projection.py)
//        counts [T]       i32  live rows per tile (rows >= count are ignored)
//        pix    [T, 8, NPIX] f32  rows 0-2 unit ray dir, row 3 column, row 4 row
//   out         [T, 8, NPIX] f32  rows 0..C-1 features, row C depth,
//                                 row C+1 final transmittance, the rest 0
//
// Per pixel and instance: ddx, ddy on the unit cross-section basis (no
// /|u|^2: the packed u1, u2 are unit vectors), power from the conic,
// alpha = min(op * exp(power), alpha_clamp). The instance passes iff it is
// inside the count and its parity rect, power <= 0 and alpha >= alpha_min.
// Front to back, the walk stops at the first passed instance with
// T * (1 - alpha) < transmittance_min, and that instance is not applied.
//
// What bounds it on an H100. At the render configuration (T = 336 tiles,
// K = 768, F = 24, NPIX = 512) the kernel reads at most 336*768*24*4 B =
// 24.8 MB of instances plus 5.5 MB of pixel blocks and output: ~9 us at
// 3.35 TB/s. It evaluates at most 336*512*768 = 132 M pixel-instance pairs
// at ~35 FP32 operations each (rect test, two 3-dot products, the
// quadratic form, expf, the transmittance update): ~70 us at 67 TFLOP/s.
// So it is bound by operations (FMA and expf), and the early exit lowers
// the work that the data actually needs.
//
// Design, simple first:
//   * one block per tile, one thread per pixel (512 threads at tile_h = 4);
//   * the tile's instance rows are staged through shared memory in chunks
//     of kChunk rows, read by all threads as broadcasts;
//   * each thread walks the chunk sequentially, testing the cheap rect and
//     count conditions before the geometry and the expf, so instances that
//     do not cover the pixel cost a few compares;
//   * the block stops staging chunks once every pixel has crossed the
//     transmittance threshold (__syncthreads_or on "not done").
// The per-pair alpha math and the step rule live in composite_common.cuh,
// shared with the backward kernel K2, which replays this walk.
// The TPU kernel's Hillis-Steele prefix over sublanes served the TPU's
// layout and is not carried over: a thread multiplies T sequentially, as the
// reference CUDA rasterizer does.
//
// K3, the window form (`lidargs_composite_fwd_windows`), replaces the TPU
// kernel `_fwd_kernel_fused` (reached through `_fused_fwd_call` and
// `composite_windows_pallas`). It is K1's body with one change: tile t reads
// its rows from buf + starts[t] * F, a window of one dense depth-sorted
// buffer [E + K, F] (K zero rows of padding, so no window runs off its end),
// instead of inst + t * K * F. Both forms are instances of one template, so
// K3 gives K1's bits on the same rows. The TPU kernel's double-buffered
// window DMA and its feature padding to 128 lanes served the TPU and are not
// carried over: the block stages its window's first `count` rows through
// shared memory as K1 stages its tile's.
#include <cuda_runtime.h>

#include "composite_common.cuh"

using namespace lidargs;

namespace {

constexpr int kChunk = 64;     // instance rows staged per shared-memory chunk

// kWindows: tile t's rows start at inst + starts[t] * F (K3), else at
// inst + t * K * F (K1; starts is not read).
template <int C, bool kWindows>
__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, float* __restrict__ out, int K, int F, int npix,
    float alpha_min, float alpha_clamp, float t_min) {
  extern __shared__ float rows[];   // [kChunk][F]
  constexpr int kRect = kFeat0 + C;
  const int t = blockIdx.x;
  const int p = threadIdx.x;

  const float* tp = pix + (size_t)t * kOutRows * npix;
  const float dirx = tp[p], diry = tp[npix + p], dirz = tp[2 * npix + p];
  const float px = tp[3 * npix + p], py = tp[4 * npix + p];
  const int count = min(max(counts[t], 0), K);
  const float* ti = inst + (kWindows ? (size_t)starts[t] * F : (size_t)t * K * F);

  float T = 1.f, dep = 0.f;
  float acc[C];
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
        if (!(px >= r[kRect] && px < r[kRect + 1] && py >= r[kRect + 2] &&
              py < r[kRect + 3]))
          continue;
        PairGeom g;
        pair_power(r, dirx, diry, dirz, g);
        if (!(g.power <= 0.f)) continue;
        pair_alpha(r, alpha_clamp, g);
        if (!(g.alpha >= alpha_min)) continue;
        const float T_next = transmit(T, g.alpha);
        if (T_next < t_min) {           // crossing: not applied, pixel done
          done = true;
          break;
        }
        const float w = g.alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * r[kFeat0 + c];
        dep += w * r[kDepth];
        T = T_next;
      }
    }
    if (!__syncthreads_or(!done)) break;             // every pixel has crossed
  }

  float* to = out + (size_t)t * kOutRows * npix;
#pragma unroll
  for (int c = 0; c < C; ++c) to[c * npix + p] = acc[c];
  to[C * npix + p] = dep;
  to[(C + 1) * npix + p] = T;
  for (int rr = C + 2; rr < kOutRows; ++rr) to[rr * npix + p] = 0.f;
}

template <int C>
cudaError_t launch(const float* inst, const int* starts, const int* counts, const float* pix,
                   float* out, int T, int K, int F, int npix, float alpha_min,
                   float alpha_clamp, float t_min, cudaStream_t stream) {
  const size_t smem = (size_t)kChunk * F * sizeof(float);
  if (starts)
    composite_fwd_kernel<C, true><<<T, npix, smem, stream>>>(
        inst, starts, counts, pix, out, K, F, npix, alpha_min, alpha_clamp, t_min);
  else
    composite_fwd_kernel<C, false><<<T, npix, smem, stream>>>(
        inst, starts, counts, pix, out, K, F, npix, alpha_min, alpha_clamp, t_min);
  return cudaGetLastError();
}

// K1 where starts is null, K3 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             float* out, int T, int K, int F, int npix, int C, float alpha_min,
             float alpha_clamp, float t_min, void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kFeat0 + C + 4 || C < 1 || C > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 2: return (int)launch<2>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 3: return (int)launch<3>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 4: return (int)launch<4>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    case 5: return (int)launch<5>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
    default: return (int)launch<6>(inst, starts, counts, pix, out, T, K, F, npix, alpha_min, alpha_clamp, t_min, s);
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller has checked shapes, types, contiguity and the device.
int lidargs_composite_fwd(const float* inst, const int* counts, const float* pix,
                          float* out, int T, int K, int F, int npix, int C,
                          float alpha_min, float alpha_clamp, float t_min,
                          void* stream) {
  return dispatch(inst, nullptr, counts, pix, out, T, K, F, npix, C, alpha_min, alpha_clamp,
                  t_min, stream);
}

// Launches K3 on `stream`: tile t composites rows [starts[t], starts[t] +
// min(counts[t], K)) of buf [E, F]. The caller has checked shapes, types,
// contiguity and the device, and that every window lies inside buf.
int lidargs_composite_fwd_windows(const float* buf, const int* starts, const int* counts,
                                  const float* pix, float* out, int T, int K, int F,
                                  int npix, int C, float alpha_min, float alpha_clamp,
                                  float t_min, void* stream) {
  return dispatch(buf, starts, counts, pix, out, T, K, F, npix, C, alpha_min, alpha_clamp,
                  t_min, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
