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
// Design (redesigned for the H100 after the first port, which walked
// every row of a tile in every warp):
//   * one thread per pixel, in blocks of kBlockPixels = 128: a tile of
//     tile_h pixel rows takes tile_h blocks, each staging the tile's rows
//     (from L2 after the first). At the render tiling that is 1344 blocks,
//     ~10 an SM, where one block of 512 a tile left 336 blocks, 2.55 an SM,
//     and the SMs that ran 3 set the time (utils/kernel_ab.py: the 128-pixel
//     blocks ran ~15% faster, PERF.md);
//   * the tile's rows are staged 64 at a time through a two-stage ring in
//     shared memory by one bulk copy each (fwd_stage.cuh): chunk c + 1 lands
//     while the block walks chunk c, and a row is read as float4s;
//   * each warp reduces its pixels to a box of columns and rows, and after a
//     chunk lands builds a mask of the chunk's rows whose parity rect meets
//     the box (two ballots). It visits those rows alone, in order; on the
//     render scene two thirds of a warp's rows missed all of its lanes, and
//     each still cost the four compares of every lane (PERF.md);
//   * each lane tests the rect and count, then the geometry and the expf, as
//     before; a lane that has crossed is predicated off, a warp whose lanes
//     have all crossed skips the chunk, and the block stops staging chunks
//     once every pixel has crossed (__syncthreads_or on "not done").
// Each pixel applies the same rows in the same order as a walk over every
// row, so K1's output keeps the bits of that walk, which K2 replays.
// The per-pair alpha math and the step rule live in composite_common.cuh,
// shared with the backward kernel K2.
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
// shared memory as K1 stages its tile's (a window starts at starts[t] * F
// floats, 16-byte aligned as the bulk copy needs).
#include <cuda_runtime.h>

#include "composite_common.cuh"
#include "fwd_stage.cuh"

using namespace lidargs;

namespace {

constexpr int kBlockPixels = 128;  // pixels (threads) a block: a tile of tile_h rows takes tile_h
constexpr int kMinBlocks = 11;     // blocks an SM: the render tiling's 1344 in one wave

// kWindows: tile t's rows start at inst + starts[t] * F (K3), else at
// inst + t * K * F (K1; starts is not read). Block (t, b) takes pixels
// [b * kBlockPixels, (b + 1) * kBlockPixels) of tile t; past the tile's
// last pixel its threads are padding (whole warps for the warp votes).
template <int C, bool kWindows>
__global__ void __launch_bounds__(kBlockPixels, kMinBlocks) composite_fwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, float* __restrict__ out, int K, int F, int npix,
    float alpha_min, float alpha_clamp, float t_min) {
  extern __shared__ float4 ring[];      // [2][kFwdChunk][F / 4]: the stages
  __shared__ uint64_t full[2];          // each stage's barrier
  constexpr int kRect = kFeat0 + C;
  constexpr int kRowF4 = (kRect + 7) / 4;              // float4s through the rect
  constexpr int kRectF4 = kRect / 4;                   // the first holding the rect
  constexpr int kRectN = (kRect + 3) / 4 - kRectF4 + 1;  // float4s holding it
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.y * kBlockPixels + tid;
  const bool in = p < npix;
  const int F4 = F >> 2;

  float dirx = 0.f, diry = 0.f, dirz = 0.f, px = 0.f, py = 0.f;
  if (in) {
    const float* tp = pix + (size_t)t * kOutRows * npix + p;
    dirx = tp[0];
    diry = tp[npix];
    dirz = tp[2 * npix];
    px = tp[3 * npix];
    py = tp[4 * npix];
  }
  const WarpBox box = warp_box(in, px, py);
  const int count = min(max(counts[t], 0), K);
  const float* ti = inst + (kWindows ? (size_t)starts[t] * F : (size_t)t * K * F);
  const int n_chunks = (count + kFwdChunk - 1) / kFwdChunk;
  auto chunk_rows = [&](int ch) { return min(kFwdChunk, count - ch * kFwdChunk); };

  float T = 1.f, dep = 0.f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  bool done = !in;

  if (tid == 0) stage_init(full);
  __syncthreads();
  if (tid == 0 && n_chunks > 0) stage_load(ring, ti, chunk_rows(0) * F * 4, &full[0]);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch & 1, n = chunk_rows(ch);
    const float4* rows = ring + s * kFwdChunk * F4;
    if (tid == 0 && ch + 1 < n_chunks)   // into the stage the last barrier freed
      stage_load(ring + (s ^ 1) * kFwdChunk * F4, ti + (size_t)(ch + 1) * kFwdChunk * F,
                 chunk_rows(ch + 1) * F * 4, &full[s ^ 1]);
    stage_wait(&full[s], (ch >> 1) & 1);
    if (!__all_sync(0xffffffffu, done)) {
      const RowMask mask = warp_rows(lane, [&](int j) {
        if (j >= n) return false;
        float q[4 * kRectN];
        load_row<kRectN>(rows + j * F4 + kRectF4, q);
        return box_meets(box, q + (kRect - 4 * kRectF4));
      });
      for (int h = 0; h < 2; ++h) {      // the mask's halves, rows 0-31 and 32-63
        for (uint32_t bits = mask.half[h]; bits; bits &= bits - 1) {
          const int j = 32 * h + __ffs(bits) - 1;
          if (done) continue;             // crossed: predicated off for the warp's other rows
          float r[4 * kRowF4];
          load_row<kRowF4>(rows + j * F4, r);
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
            continue;
          }
          const float w = g.alpha * T;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += w * r[kFeat0 + c];
          dep += w * r[kDepth];
          T = T_next;
        }
      }
    }
    if (!__syncthreads_or(!done)) {     // every pixel has crossed
      if (tid == 0 && ch + 1 < n_chunks) stage_wait(&full[s ^ 1], ((ch + 1) >> 1) & 1);
      break;                            // (no copy may land after the block is gone)
    }
  }

  if (!in) return;
  float* to = out + (size_t)t * kOutRows * npix + p;
#pragma unroll
  for (int c = 0; c < C; ++c) to[c * npix] = acc[c];
  to[C * npix] = dep;
  to[(C + 1) * npix] = T;
  for (int rr = C + 2; rr < kOutRows; ++rr) to[rr * npix] = 0.f;
}

template <int C>
cudaError_t launch(const float* inst, const int* starts, const int* counts, const float* pix,
                   float* out, int T, int K, int F, int npix, float alpha_min,
                   float alpha_clamp, float t_min, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kFwdChunk * F * sizeof(float);
  const dim3 grid(T, (npix + kBlockPixels - 1) / kBlockPixels);
  if (starts)
    composite_fwd_kernel<C, true><<<grid, kBlockPixels, smem, stream>>>(
        inst, starts, counts, pix, out, K, F, npix, alpha_min, alpha_clamp, t_min);
  else
    composite_fwd_kernel<C, false><<<grid, kBlockPixels, smem, stream>>>(
        inst, starts, counts, pix, out, K, F, npix, alpha_min, alpha_clamp, t_min);
  return cudaGetLastError();
}

// K1 where starts is null, K3 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             float* out, int T, int K, int F, int npix, int C, float alpha_min,
             float alpha_clamp, float t_min, void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kFeat0 + C + 4 || F % 4 != 0 || C < 1 || C > kMaxC ||
      2 * (size_t)kFwdChunk * F * sizeof(float) > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(inst) % 16 != 0)
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
