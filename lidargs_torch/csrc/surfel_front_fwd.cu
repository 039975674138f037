// The forward surfel front of a re-simulated frame (kernel F2) for Hopper
// (sm_90a), bound in lidargs_torch/ops/front_kernel.py `surfel_front_packed`.
//
// Replaces no TPU kernel: the JAX package leaves the front to XLA, and the
// port ran it as ~580 small PyTorch operations (`models/field.py`
// `field_surfels`: the prefilter, the decode, `ops/surfel.py`
// `preprocess_surfels` and its concatenation). F2 computes, for the anchor
// rows [0, B) in one launch, what those operations compute:
//
//   1. the prefilter (`prefilter_anchors`) and 2. the decode
//      (`generate_neural_gaussians`, fused heads), F1's steps, from
//      `front_decode.cuh`, with its arguments, layout and rules of
//      precision; the surfel takes the first two decoded scales;
//   3. the surfel preprocess of each of the k gaussians
//      (`preprocess_surfels`), every guard included: the centre in sensor
//      space (tw, unit x on masked rows), its range and the near/far test;
//      the centre pixel (`_project_rows` at one surfel ray divergence); R of
//      the quaternion (`quat_to_rotmat`), Tu, Tv and the normal through
//      w2s_rot; the normal turned toward the sensor and the edge-on cull;
//      the four +-3 sigma axis endpoints through `_pix_f`, their largest
//      offsets from the centre, ceil'd to r_x, r_y at least 1; the 16x1
//      blocks' rect with its clamps and the empty-rect cull;
//   4. row a*k + j of the [P, F] table (`SurfelCols`, the layout K5 and K7
//      read: Tu, Tv, Tw, normal, opacity, depth, features, centre, rect,
//      valid, zero-padded) as F/4 float4 stores, depth [P] (4 far on
//      invalid rows, the cull sort's key) and valid [P], and the count of
//      valid rows (one integer atomic a block).
//
// Precision: `front_decode.cuh`'s rules. The rotation matrix's entries are
// each a chain of separately rounded products and sums (quat_to_rotmat runs
// each as its own kernel), the three [P,3] @ [3,3] products one FMA chain
// from index 0, the endpoints tw + (+-3 axis) rounded twice, max(|ex - p_c|)
// exact, floor and ceil exact.
//
// What bounds it on an H100. At `surfel-render-street`'s extent (B = 57,344,
// k = 6, P = 344,064, F = 24) it reads F1's 14.7 MB of anchor state and
// writes 33.0 MB of rows plus 1.7 MB of depth and valid: ~15 us at 3.35
// TB/s; it runs ~0.75 GFLOP of decode and ~0.1 G of preprocess (300
// operations a row): ~13 us at 67 TFLOP/s.
//
// The row is F1's walk with twice its latency-bound chains: the centre's and
// four endpoints' atan2f pairs and beam searches. The four endpoints run as
// one loop not unrolled, so a row holds one endpoint's state at a time. Four
// blocks an SM, as F1: 64 registers and no spills; at three blocks (80
// registers) F2 took 3.3% longer (0.1079 against 0.1045 ms, `kernel_ab`'s
// 65,536 anchor rows, medians of 4 turns of 50 launches, on an H100 80GB
// HBM3 at 700 W).

#include "front_decode.cuh"

namespace {

// F2's row: `preprocess_surfels`, then SurfelCols' columns.
struct SurfelPack {
  static constexpr int kBlocks = 4;
  float margin;                 // 1.0 x surfel_ray_divergence_angle: the centre's

  template <int C, int F>
  __device__ __forceinline__ bool row(const Gaussian<C>& g, const float* fr, const float* beams,
                                      const Dims& d, float (&v)[F]) const {
    const float* R = fr;
    const float Hf = (float)d.H;
    // tw_raw = means @ R^T + t; masked rows take unit x
    float p[3];
    for (int j = 0; j < 3; ++j) p[j] = fadd(mat_row(g.xyz, R, j), fr[9 + j]);
    const bool mask = g.mask && dot3(p, p) > 0.0f;
    const float tw[3] = {mask ? p[0] : 1.0f, mask ? p[1] : 0.0f, mask ? p[2] : 0.0f};
    const float dist = sqrtf(dot3(tw, tw));
    bool valid = mask && dist < d.far && dist > d.near;

    // the centre pixel, rejected beyond one ray divergence from its beam
    const float horiz2 = fadd(fmul(tw[0], tw[0]), fmul(tw[1], tw[1]));
    const bool degen = horiz2 <= 0.0f;
    valid = valid && !degen;
    const float p_c =
        fmul(fsub(kPi, atan2f(degen ? 0.0f : tw[1], degen ? 1.0f : tw[0])), d.inv_col);
    const Elev el =
        beam_row(atan2f(degen ? 0.0f : tw[2], sqrtf(degen ? 1.0f : horiz2)), beams, d.H, margin);
    valid = valid && el.ok;
    const float p_r = fsub(fsub(Hf, el.row), 1.0f);

    // quat_to_rotmat's columns: 0 and 1 times the two scales, 2 the normal;
    // Tu, Tv and the normal in sensor space
    const float qr = g.rot[0], qx = g.rot[1], qy = g.rot[2], qz = g.rot[3];
    const float s0 = g.scl[0], s1 = g.scl[1];
    const float cu[3] = {fmul(fsub(1.0f, fmul(2.0f, fadd(fmul(qy, qy), fmul(qz, qz)))), s0),
                         fmul(fmul(2.0f, fadd(fmul(qx, qy), fmul(qr, qz))), s0),
                         fmul(fmul(2.0f, fsub(fmul(qx, qz), fmul(qr, qy))), s0)};
    const float cv[3] = {fmul(fmul(2.0f, fsub(fmul(qx, qy), fmul(qr, qz))), s1),
                         fmul(fsub(1.0f, fmul(2.0f, fadd(fmul(qx, qx), fmul(qz, qz)))), s1),
                         fmul(fmul(2.0f, fadd(fmul(qy, qz), fmul(qr, qx))), s1)};
    const float cn[3] = {fmul(2.0f, fadd(fmul(qx, qz), fmul(qr, qy))),
                         fmul(2.0f, fsub(fmul(qy, qz), fmul(qr, qx))),
                         fsub(1.0f, fmul(2.0f, fadd(fmul(qx, qx), fmul(qy, qy))))};
    float tu[3], tv[3], nr[3];
    for (int j = 0; j < 3; ++j) {
      tu[j] = mat_row(cu, R, j);
      tv[j] = mat_row(cv, R, j);
      nr[j] = mat_row(cn, R, j);
    }

    // the normal toward the sensor; exactly edge-on surfels culled
    const float cosv = -dot3(tw, nr);
    valid = valid && cosv != 0.0f;
    const float flip = cosv > 0.0f ? 1.0f : -1.0f;
    for (int i = 0; i < 3; ++i) nr[i] = fmul(nr[i], flip);

    // the +-3 sigma axis endpoints through `_pix_f` (no divergence test)
    float ext_x = 0.0f, ext_y = 0.0f;
#pragma unroll 1
    for (int e = 0; e < 4; ++e) {
      const float s3 = (e & 1) ? -3.0f : 3.0f;
      float pe[3];
      for (int i = 0; i < 3; ++i) pe[i] = fadd(tw[i], fmul(s3, e < 2 ? tu[i] : tv[i]));
      const float h2 = fadd(fmul(pe[0], pe[0]), fmul(pe[1], pe[1]));
      const bool safe = h2 > 0.0f;
      const float ex = fmul(fsub(kPi, atan2f(pe[1], safe ? pe[0] : 1.0f)), d.inv_col);
      const Elev ee = beam_row(atan2f(pe[2], sqrtf(safe ? h2 : 1.0f)), beams, d.H, 0.0f);
      const float ey = fsub(fsub(Hf, ee.row), 1.0f);
      ext_x = fmaxf(ext_x, fabsf(fsub(ex, p_c)));
      ext_y = fmaxf(ext_y, fabsf(fsub(ey, p_r)));
    }

    // the reference's 16x1 blocks: x in blocks of bx, y a bare round(p_r + r_y)
    const float r_x = ceilf(fmaxf(ext_x, 1.0f)), r_y = ceilf(fmaxf(ext_y, 1.0f));
    const float gx = (float)d.grid_x;
    const float rmin_x = clampf(floorf(fmul(fsub(p_c, r_x), d.inv_bx)), 0.0f, gx);
    const float rmax_x =
        clampf(floorf(fmul(fsub(fadd(fadd(p_c, r_x), d.bx), 1.0f), d.inv_bx)), 0.0f, gx);
    const float rmin_y = clampf(floorf(fsub(p_r, r_y)), 0.0f, Hf);
    const float rmax_y = clampf(floorf(fadd(fadd(p_r, r_y), 0.5f)), 0.0f, Hf);
    valid = valid && fmul(fsub(rmax_x, rmin_x), fsub(rmax_y, rmin_y)) > 0.0f;

    for (int i = 0; i < 3; ++i) {
      v[i] = tu[i];
      v[3 + i] = tv[i];
      v[6 + i] = tw[i];
      v[9 + i] = nr[i];
    }
    v[12] = valid ? g.op : 0.0f;
    v[13] = valid ? dist : d.sentinel;
    for (int cc = 0; cc < C; ++cc) v[14 + cc] = g.col[cc];
    v[14 + C] = p_c;
    v[15 + C] = p_r;
    v[16 + C] = fmul(rmin_x, d.bx);
    v[17 + C] = fmul(rmax_x, d.bx);
    v[18 + C] = rmin_y;
    v[19 + C] = rmax_y;
    v[20 + C] = valid ? 1.0f : 0.0f;
    for (int i = 21 + C; i < F; ++i) v[i] = 0.0f;
    return valid;
  }
};

}  // namespace

extern "C" {

// Launches F2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// F1's arguments (`lidargs_front_fwd`, whose checks the caller has made)
// and the centre's divergence margin last.
int lidargs_surfel_front_fwd(
    const float* anchor, const float* offset, const float* feat, const float* scaling,
    const float* rotation, const unsigned char* valid, const float* w1_op, const float* b1_op,
    const float* w2_op, const float* b2_op, const float* w1_col, const float* b1_col,
    const float* w2_col, const float* b2_col, const float* w1_rd, const float* b1_rd,
    const float* w2_rd, const float* b2_rd, const float* w1_cov, const float* b1_cov,
    const float* w2_cov, const float* b2_cov, const float* w2s_rot, const float* w2s_trans,
    const float* center, const float* beams, float* pk, float* depth, unsigned char* valid_out,
    long long* n_valid, int B, int k, int fd, int d_in, int C, int H, int W, int bx, int by,
    float near, float far, float lowpass, float margin, float col_pitch, float inv_col,
    float inv_bx, float inv_by, float sentinel, float surfel_margin, void* stream) {
  const float* heads[16] = {w1_op, b1_op, w2_op, b2_op, w1_col, b1_col, w2_col, b2_col,
                            w1_rd, b1_rd, w2_rd, b2_rd, w1_cov, b1_cov, w2_cov, b2_cov};
  return launch_front(anchor, offset, feat, scaling, rotation, valid, heads, w2s_rot,
                      w2s_trans, center, beams, pk, depth, valid_out, n_valid, B, k, fd, d_in,
                      C, H, W, bx, by, near, far, lowpass, margin, col_pitch, inv_col, inv_bx,
                      inv_by, sentinel, SurfelPack{surfel_margin}, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
