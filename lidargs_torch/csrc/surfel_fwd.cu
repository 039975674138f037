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
// Design, as K1's (composite_fwd.cu):
//   * one thread per pixel, in blocks of kBlockPixels = 128 (one block a
//     tile at tile_h = 1: 1344 at the surfel tiling), bounded for
//     kMinBlocks = 10 an SM: nvcc then keeps 48 registers and spills 64
//     bytes, which ran faster in utils/kernel_ab.py than 40 registers (11
//     or 12 an SM, 128 bytes spilled), 56 (9) or 60 (8, no spills), PERF.md;
//   * the tile's rows are staged 64 at a time through a two-stage ring by
//     one bulk copy each (fwd_stage.cuh), chunk c + 1 landing while the
//     block walks chunk c, and a row is read as float4s;
//   * once a chunk has landed, its rows' invariants (`SurfelRow`: the center
//     range rho_r with its square root, Tw . n and the clamped |Tu|^2,
//     |Tv|^2) are computed once per row into shared memory, with the
//     intrinsics and order of `surfel_pair`, which K6 calls per pair: a
//     pair reads them as one float4 in place of ~30 instructions;
//   * each warp builds a mask of the chunk's rows that are valid
//     and whose parity rect meets the box of its pixels, and visits those
//     alone, in order, each lane testing the valid flag and the rect before
//     the geometry and the expf; a lane that has crossed is predicated off;
//   * the block stops staging rows once every pixel has crossed the
//     transmittance threshold (__syncthreads_or on "not done").
// Each pixel applies the same rows in the same order, with the same bits,
// as a walk over every row, which K6 replays.
// The TPU kernel's Hillis-Steele prefix products and sums over sublanes
// served the TPU's layout and are not carried over: a thread multiplies T
// and sums M1, M2 in sequence.
//
// K7, the window form (`lidargs_surfel_fwd_windows`), replaces the TPU
// kernel `_fwd_kernel_fused` of pallas_surfel.py (reached through its
// `_fused_fwd_call` and `surfel_composite_windows`). It is K5's body with
// one change, as K3 is K1's (composite_fwd.cu): tile t reads its rows from
// buf + starts[t] * F, a window of one dense depth-sorted buffer [E + K, F]
// with K zero rows of padding (16-byte aligned, as the bulk copy needs). One
// template serves both, so K7 gives K5's bits on the same rows, the
// median's included.
#include <cuda_runtime.h>

#include "fwd_stage.cuh"
#include "surfel_common.cuh"

using namespace lidargs;

namespace {

constexpr int kBlockPixels = 128;  // pixels (threads) a block: a tile of tile_h rows takes tile_h
constexpr int kMinBlocks = 10;     // blocks an SM (see the design notes above)

// The row invariants of rows [0, n) of a landed stage, one thread a row.
__device__ __forceinline__ void hoist_rows(const float4* __restrict__ rows, int F4, int n,
                                           float4* __restrict__ inv) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float r[12];                         // Tu, Tv, Tw, n
    load_row<3>(rows + i * F4, r);
    SurfelRow q;
    float tw_sq, tu_sq, tv_sq;
    surfel_row(r, q, tw_sq, tu_sq, tv_sq);
    inv[i] = make_float4(q.rho_r, q.lam, q.tu_tu, q.tv_tv);
  }
}

// kWindows: tile t's rows start at inst + starts[t] * F (K7), else at
// inst + t * K * F (K5; starts is not read). Block (t, b) takes pixels
// [b * kBlockPixels, (b + 1) * kBlockPixels) of tile t; past the tile's
// last pixel its threads are padding (whole warps for the warp votes).
template <int C, bool kWindows>
__global__ void __launch_bounds__(kBlockPixels, kMinBlocks) surfel_fwd_kernel(
    const float* __restrict__ inst, const int* __restrict__ starts,
    const int* __restrict__ counts,
    const float* __restrict__ pix, float* __restrict__ out, int K, int F, int npix,
    SurfelConsts kc) {
  extern __shared__ float4 ring[];         // [2][kFwdChunk][F / 4]: the stages
  __shared__ uint64_t full[2];             // each stage's barrier
  __shared__ float4 inv[2][kFwdChunk];     // each staged row's SurfelRow
  constexpr int kCen = kSFeat0 + C, kRect = kCen + 2, kValid = kCen + 6;
  constexpr int kRowF4 = (kValid + 4) / 4;               // float4s through the valid flag
  constexpr int kRectF4 = kRect / 4;                     // the first holding the rect
  constexpr int kRectN = kValid / 4 - kRectF4 + 1;       // those holding it and the flag
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.y * kBlockPixels + tid;
  const bool in = p < npix;
  const int F4 = F >> 2;

  float dirx = 0.f, diry = 0.f, dirz = 0.f, px = 0.f, py = 0.f;
  if (in) {
    const float* tp = pix + (size_t)t * kPixRows * npix + p;
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

  float T = 1.f, dep = 0.f, med = 0.f, dist = 0.f, m1 = 0.f, m2 = 0.f;
  float acc[C], nrm[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  bool done = !in;

  if (tid == 0) stage_init(full);
  __syncthreads();
  if (n_chunks > 0) {
    if (tid == 0) stage_load(ring, ti, chunk_rows(0) * F * 4, &full[0]);
    stage_wait(&full[0], 0);
    hoist_rows(ring, F4, chunk_rows(0), inv[0]);
    __syncthreads();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunk ch has landed in stage s and its invariants are in inv[s]
    const int s = ch & 1, n = chunk_rows(ch);
    const bool more = ch + 1 < n_chunks;
    const float4* rows = ring + s * kFwdChunk * F4;
    float4* next = ring + (s ^ 1) * kFwdChunk * F4;
    if (tid == 0 && more)                 // into the stage the last barrier freed
      stage_load(next, ti + (size_t)(ch + 1) * kFwdChunk * F, chunk_rows(ch + 1) * F * 4,
                 &full[s ^ 1]);
    if (!__all_sync(0xffffffffu, done)) {
      const RowMask mask = warp_rows(lane, [&](int j) {
        if (j >= n) return false;
        float q[4 * kRectN];
        load_row<kRectN>(rows + j * F4 + kRectF4, q);
        return q[kValid - 4 * kRectF4] > 0.f && box_meets(box, q + (kRect - 4 * kRectF4));
      });
      for (int h = 0; h < 2; ++h) {      // the mask's halves, rows 0-31 and 32-63
        for (uint32_t bits = mask.half[h]; bits; bits &= bits - 1) {
          const int j = 32 * h + __ffs(bits) - 1;
          if (done) continue;               // crossed: predicated off for the warp's other rows
          float r[4 * kRowF4];
          load_row<kRowF4>(rows + j * F4, r);
          if (!(r[kValid] > 0.f)) continue;
          if (!(px >= r[kRect] && px < r[kRect + 1] && py >= r[kRect + 2] &&
                py < r[kRect + 3]))
            continue;
          const float4 v = inv[s][j];
          SurfelGeom g;
          surfel_pair_at(r, SurfelRow{v.x, v.y, v.z, v.w}, kCen, dirx, diry, dirz, px, py,
                         kc.fis, g);
          if (!(g.hit && g.depth >= kc.near && g.power <= 0.f)) continue;
          surfel_alpha(r, kc.alpha_clamp, g);
          if (!(g.alpha >= kc.alpha_min)) continue;
          const float T_next = transmit(T, g.alpha);
          if (T_next < kc.t_min) {          // crossing: not applied, pixel done
            done = true;
            continue;
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
          if (T > 0.5f) med = g.depth;      // the last applied row with T-before > 0.5
          T = T_next;
        }
      }
    }
    if (more) {                           // chunk ch + 1 has landed: its invariants
      stage_wait(&full[s ^ 1], ((ch + 1) >> 1) & 1);
      hoist_rows(next, F4, chunk_rows(ch + 1), inv[s ^ 1]);
    }
    if (!__syncthreads_or(!done)) break;  // every pixel has crossed (no copy in flight)
  }

  if (!in) return;
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
  const size_t smem = 2 * (size_t)kFwdChunk * F * sizeof(float);
  const dim3 grid(T, (npix + kBlockPixels - 1) / kBlockPixels);
  if (starts)
    surfel_fwd_kernel<C, true><<<grid, kBlockPixels, smem, stream>>>(inst, starts, counts, pix,
                                                                     out, K, F, npix, kc);
  else
    surfel_fwd_kernel<C, false><<<grid, kBlockPixels, smem, stream>>>(inst, starts, counts, pix,
                                                                      out, K, F, npix, kc);
  return cudaGetLastError();
}

// K5 where starts is null, K7 otherwise.
int dispatch(const float* inst, const int* starts, const int* counts, const float* pix,
             float* out, int T, int K, int F, int npix, int C, const SurfelConsts& kc,
             void* stream) {
  if (T <= 0) return 0;
  if (npix <= 0 || npix > 1024 || F < kSFeat0 + C + 7 || F % 4 != 0 || C < 1 ||
      C > kSurfelMaxC || 2 * (size_t)kFwdChunk * F * sizeof(float) > 48 * 1024 ||
      reinterpret_cast<uintptr_t>(inst) % 16 != 0)
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
