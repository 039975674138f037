// The forward beam front of a re-simulated frame (kernel F1) for Hopper
// (sm_90a), bound in lidargs_torch/ops/front_kernel.py `front_packed`.
//
// Replaces no TPU kernel: the JAX package leaves the front to XLA, and the
// port ran it as ~300 small PyTorch operations (`models/field.py`
// `field_splats`, then `ops/projection.py` `pack_splats`). F1 computes, for
// the anchor rows [0, B) in one launch, what those operations compute:
//
//   1. the prefilter (`prefilter_anchors`): each live anchor projected as a
//      gaussian with scales exp(scaling[:3]) and its normalized rotation,
//      kept where the projection's `valid` holds;
//   2. the decode (`generate_neural_gaussians`, fused heads): the view
//      direction and distance, the fused first layer [feat, ob_view,
//      ob_dist] -> 4 x 32 with ReLU, the four second layers, tanh and the
//      two sigmoids, the scales, the normalized quaternion (unit-x guard)
//      and the means; mask = valid & visible & (opacity > 0);
//   3. the projection of each of the k gaussians (`preprocess_gaussians`),
//      every guard included;
//   4. row a*k + j of the packed [P, F] table (`PackedCols`, the layout K1
//      reads) as F/4 float4 stores, depth [P] and valid [P] for the cull
//      sort, and the count of valid rows (one integer atomic a block).
//
// Steps 1, 2 and the walk over the anchors are `front_decode.cuh`'s, shared
// with the surfel front F2 (`surfel_front_fwd.cu`), with its arguments,
// layout and rules of precision; the projection (`project`) is there too,
// since the prefilter of both runs it. Here: the packed row.
//
// What bounds it on an H100. At the render cells' extent (B = 57,344, k = 6,
// P = 344,064, F = 24) it reads 14.7 MB of anchor state and writes 33.0 MB
// of packed rows plus 1.7 MB of depth and valid: ~15 us at 3.35 TB/s; it
// runs ~0.85 GFLOP (the first layer 0.53, the second 0.22, the prefilter
// and projection ~0.1): ~13 us at 67 TFLOP/s.
//
// Four blocks an SM (64 registers, ~55 KB of shared memory each): the
// projection's chains of IEEE divisions, square roots and atan2f are
// latency-bound, and at three blocks (80-102 registers) F1 took 13-14% longer
// on an H100 (80GB HBM3, 700 W).

#include "front_decode.cuh"

namespace {

// F1's row: the projection, then PackedCols' columns.
struct BeamPack {
  static constexpr int kBlocks = 4;

  template <int C, int F>
  __device__ __forceinline__ bool row(const Gaussian<C>& g, const float* fr, const float* beams,
                                      const Dims& d, float (&v)[F]) const {
    const Row pr = project(g.xyz, g.scl, g.rot, g.op, g.mask, fr, beams, d);
    for (int i = 0; i < 3; ++i) {
      v[i] = pr.mean[i];
      v[3 + i] = pr.u1[i];
      v[6 + i] = pr.u2[i];
      v[9 + i] = pr.conic[i];
    }
    v[12] = pr.opacity;
    v[13] = pr.depth;
    for (int cc = 0; cc < C; ++cc) v[14 + cc] = g.col[cc];
    for (int i = 0; i < 4; ++i) v[14 + C + i] = pr.rect[i];
    v[18 + C] = pr.center[0];
    v[19 + C] = pr.center[1];
    v[20 + C] = pr.valid ? 1.0f : 0.0f;
    for (int i = 21 + C; i < F; ++i) v[i] = 0.0f;
    return pr.valid;
  }
};

}  // namespace

extern "C" {

// Launches F1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// The caller has checked shapes, types, contiguity and the device, that
// the heads are 32 wide, and has zeroed n_valid. C in 1..4, H >= 2.
int lidargs_front_fwd(const float* anchor, const float* offset, const float* feat,
                      const float* scaling, const float* rotation, const unsigned char* valid,
                      const float* w1_op, const float* b1_op, const float* w2_op,
                      const float* b2_op, const float* w1_col, const float* b1_col,
                      const float* w2_col, const float* b2_col, const float* w1_rd,
                      const float* b1_rd, const float* w2_rd, const float* b2_rd,
                      const float* w1_cov, const float* b1_cov, const float* w2_cov,
                      const float* b2_cov, const float* w2s_rot, const float* w2s_trans,
                      const float* center, const float* beams, float* pk, float* depth,
                      unsigned char* valid_out, long long* n_valid, int B, int k, int fd,
                      int d_in, int C, int H, int W, int bx, int by, float near, float far,
                      float lowpass, float margin, float col_pitch, float inv_col,
                      float inv_bx, float inv_by, float sentinel, void* stream) {
  const float* heads[16] = {w1_op, b1_op, w2_op, b2_op, w1_col, b1_col, w2_col, b2_col,
                            w1_rd, b1_rd, w2_rd, b2_rd, w1_cov, b1_cov, w2_cov, b2_cov};
  return launch_front(anchor, offset, feat, scaling, rotation, valid, heads, w2s_rot,
                      w2s_trans, center, beams, pk, depth, valid_out, n_valid, B, k, fd, d_in,
                      C, H, W, bx, by, near, far, lowpass, margin, col_pitch, inv_col, inv_bx,
                      inv_by, sentinel, BeamPack{}, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
