// Row staging and the per-warp row mask shared by the forward composite
// kernels: K1/K3 (composite_fwd.cu) and K5/K7 (surfel_fwd.cu).
//
// Staging. A tile's rows pass through a two-stage ring in shared memory,
// kFwdChunk rows a stage. One thread fills a stage with one bulk copy
// (`cp.async.bulk`, the TMA's 1-D form: the other threads spend no
// registers or instructions on it) that completes on the stage's mbarrier.
// The block issues chunk c + 1 before it walks chunk c, so the copy lands
// while the walk runs, and one barrier a chunk (the early exit's vote)
// orders the walk's reads of a stage before the copy that refills it. A
// bulk copy moves whole 16-byte units from and to 16-byte aligned
// addresses: rows of F floats with F % 4 == 0 from a 16-byte aligned base,
// which the wrappers check (`ops/composite_kernel.py`, `check_rows_aligned`).
//
// The row mask. A warp's 32 pixels lie in a box of columns and rows, and a
// row whose parity rect misses that box fails every lane's rect test. Lane
// l tests rows l and l + 32 of a stage against the box, and two ballots give
// the warp a mask of the rows that can touch one of its pixels. The walk
// visits those alone, in order, and each lane still runs every one of
// its own tests on them. So each pixel applies the same rows in the same
// order as a walk over all of them: the output keeps its bits, and the
// backward kernels, which replay the full walk, stay in step with it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lidargs {

constexpr int kFwdChunk = 64;   // rows a stage holds: one bit each of the warp's mask

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the two stages' barriers (one arrival a phase: the issuing
// thread's), made visible to the bulk copies. The block synchronises after.
__device__ __forceinline__ void stage_init(uint64_t* full) {
  const uint32_t one = 1;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(full)), "r"(one)
               : "memory");
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(full + 1)), "r"(one)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16) from global `src` to shared
// `dst` (both 16-byte aligned), completing on the next phase of `bar`.
__device__ __forceinline__ void stage_load(void* dst, const void* src, uint32_t bytes,
                                           uint64_t* bar) {
  // the block's reads of dst (generic proxy), ordered before this thread by
  // the barrier that ended the walk, come before the copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed: the
// stage's copy has landed and is visible to this thread.
__device__ __forceinline__ void stage_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ready = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ready);
}

// The first N float4s of a staged row, as floats: N LDS.128 a row.
template <int N>
__device__ __forceinline__ void load_row(const float4* __restrict__ src, float* r) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 v = src[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

// The box [x_lo, x_hi] x [y_lo, y_hi] of a warp's pixel columns and rows.
// A lane past the tile's pixels (in == false) adds nothing to it.
struct WarpBox {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ WarpBox warp_box(bool in, float px, float py) {
  const float inf = __int_as_float(0x7f800000);
  WarpBox b{in ? px : inf, in ? px : -inf, in ? py : inf, in ? py : -inf};
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    b.x_lo = fminf(b.x_lo, __shfl_xor_sync(0xffffffffu, b.x_lo, o));
    b.x_hi = fmaxf(b.x_hi, __shfl_xor_sync(0xffffffffu, b.x_hi, o));
    b.y_lo = fminf(b.y_lo, __shfl_xor_sync(0xffffffffu, b.y_lo, o));
    b.y_hi = fmaxf(b.y_hi, __shfl_xor_sync(0xffffffffu, b.y_hi, o));
  }
  return b;
}

// Whether the rect [x0, x1) x [y0, y1) can hold a pixel of the box: a lane's
// test px >= x0 && px < x1 && py >= y0 && py < y1 passes only if it can
// (x0 <= px <= x_hi and x_lo <= px < x1, and the same for the rows).
__device__ __forceinline__ bool box_meets(const WarpBox& b, const float* rect) {
  return rect[0] <= b.x_hi && rect[1] > b.x_lo && rect[2] <= b.y_hi && rect[3] > b.y_lo;
}

// A warp's mask of a stage's rows: bit j % 32 of half[j / 32] for row j.
struct RowMask {
  uint32_t half[2];
};

// The warp's mask of the rows j with meets(j), from rows lane and lane + 32.
// Every lane of the warp calls it. The walk takes the halves one after the
// other, on 32-bit words.
template <class Meets>
__device__ __forceinline__ RowMask warp_rows(int lane, Meets meets) {
  return RowMask{{__ballot_sync(0xffffffffu, meets(lane)),
                  __ballot_sync(0xffffffffu, meets(lane + 32))}};
}

}  // namespace lidargs
