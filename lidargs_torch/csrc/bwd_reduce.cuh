// The row reduction shared by the backward composite kernels (composite_bwd.cu,
// K2 and K4; surfel_bwd.cu, K6 and K8). Each row's gradient is a sum over
// the tile's pixels, one thread per pixel, taken without atomics and in a
// fixed order, so two launches give the same bits:
//
//   1. per warp and row: nothing where no lane applied the row; the lane's
//      own values where one lane did (vector stores, no shuffle); else a
//      transpose-reduce butterfly that sums 16 columns over the 32 lanes in
//      8 + 4 + 2 + 1 + 1 = 16 shuffles (a lane sends half of its remaining
//      columns at each step and keeps the other half, so column k's sum ends
//      in lanes 2k and 2k + 1), then one coalesced store; columns past 16
//      take a plain butterfly each. The warp's partial goes to shared memory
//      and the row's bit is set in the warp's 64-bit "touched" word;
//   2. per chunk of kBwdRows rows, after a block barrier: warp w sums rows
//      w, w + n_warps, ... over the warps whose touched word has the row's
//      bit, in ascending warp order, one lane per column, and writes each row
//      once. Warps that never touched a row cost it nothing.
//
// The xor distances of the transpose-reduce are those of a plain butterfly
// (16, 8, 4, 2, 1), so each column's sum is the same tree of additions, and
// adding a warp's zero partial or a lane's zeros changes no sum but a zero's
// sign: the rows equal (torch.equal) those of a butterfly per column over
// every warp.

#pragma once

#include <cuda_runtime.h>

namespace lidargs {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBwdRows = 64;   // rows staged per chunk: one bit each of a warp's touched word
using RowBits = unsigned long long;   // a warp's touched word: bit j, row j of the chunk

// Column i of the live columns: the i-th column of 0, 1, ... that is not kSkip.
template <int kSkip>
__device__ __forceinline__ int live_col(int i) {
  return kSkip >= 0 && i >= kSkip ? i + 1 : i;
}

// One step of the transpose-reduce: lanes l and l ^ (2H) exchange halves of
// their first 2H values; each keeps H of them, summed over both lanes.
template <int H>
__device__ __forceinline__ void transpose_step(float (&t)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? t[i] : t[i + H];
    const float keep = upper ? t[i + H] : t[i];
    t[i] = keep + __shfl_xor_sync(kFullMask, send, 2 * H);
  }
}

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Stores the warp's sums of v's columns at pw[0..NV): `hits` is the ballot
// of the lanes that applied the row (nonzero); lanes outside it hold zeros.
// Column kSkip (if >= 0) is zero in every lane and is not reduced; with one
// lane in `hits` it is stored (as that lane's zero), else it is left as it
// was, and the caller does not read it. pw is 16-byte aligned; v has NP
// entries, those past NV zero.
template <int NV, int NP, int kSkip>
__device__ __forceinline__ void store_warp_sum(const float (&v)[NP], unsigned hits, int lane,
                                               float* __restrict__ pw) {
  if (__popc(hits) == 1) {                 // one lane applied the row: its values are the sums
    if ((hits >> lane) & 1u) {
      float4* p4 = reinterpret_cast<float4*>(pw);
#pragma unroll
      for (int k = 0; k < NP / 4; ++k)
        p4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
    return;
  }
  constexpr int L = kSkip >= 0 ? NV - 1 : NV;   // the live columns
  float t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = i < L ? v[live_col<kSkip>(i)] : 0.f;
  transpose_step<8>(t, lane);
  transpose_step<4>(t, lane);
  transpose_step<2>(t, lane);
  transpose_step<1>(t, lane);
  t[0] += __shfl_xor_sync(kFullMask, t[0], 1);
  const int i = lane >> 1;                 // lanes 2i and 2i + 1 hold live column i's sum
  if (!(lane & 1) && i < L) pw[live_col<kSkip>(i)] = t[0];
#pragma unroll
  for (int i2 = 16; i2 < L; ++i2) {
    const float s = butterfly_sum(v[live_col<kSkip>(i2)]);
    if (lane == 0) pw[live_col<kSkip>(i2)] = s;
  }
}

// Writes rows [0, n) of a chunk to out (row stride F): column c < NV but
// kSkip of row j is the sum of part[w][j][c] (row stride NP, kBwdRows rows a
// warp) over the warps w whose touched[w] has bit j, in ascending w; every
// other column is zero. Called by every thread of the block, after the
// barrier that completes the chunk's partials.
template <int NV, int NP, int kSkip>
__device__ __forceinline__ void write_chunk(const float* __restrict__ part,
                                            const RowBits* __restrict__ touched, int n,
                                            int F, int n_warps, int warp, int lane,
                                            float* __restrict__ out) {
  const RowBits mine = lane < n_warps ? touched[lane] : 0;
  for (int j = warp; j < n; j += n_warps) {
    const unsigned by = __ballot_sync(kFullMask, (mine >> j) & 1u);   // bit w: warp w touched row j
    float* o = out + (size_t)j * F;
    for (int c = lane; c < F; c += 32) {
      float s = 0.f;
      if (c < NV && c != kSkip)
        for (unsigned m = by; m; m &= m - 1)
          s += part[((__ffs(m) - 1) * kBwdRows + j) * NP + c];
      o[c] = s;
    }
  }
}

}  // namespace lidargs
