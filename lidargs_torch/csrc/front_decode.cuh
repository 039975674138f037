// The body of the forward fronts of a re-simulated frame, shared by F1
// (front_fwd.cu, the beam splats) and F2 (surfel_front_fwd.cu, the surfels):
// the prefilter, the heads staged in shared memory, the decode, the walk
// over tiles of anchors and the count of valid rows. Each front brings its
// own row: a policy `Pack` whose `row` turns one decoded gaussian into its
// F columns (the depth at column 13, the sort key, in both layouts) and its
// verdict `valid`, and whose kBlocks is the blocks an SM it is built for.
//
//   in   anchor [B,3] offset [B,k,3] feat [B,fd] scaling [B,6] rotation [B,4]
//        f32, valid [B] u8; the heads' l1 w [d_in,32] b [32], l2 w [32,n]
//        b [n] (opacity n = k, color (C-1)k, raydrop k, cov 7k); the
//        frame's w2s_rot [3,3], w2s_trans [3], center [3], beams [H] f32
//   out  pk [B*k, F] f32, depth [B*k] f32, valid [B*k] u8, n_valid i64 (+=)
//
// Every row is decoded and packed, those of dead or culled anchors
// included: the torch path masks them instead of compacting, and their
// columns come from the decode of the masked row.
//
// Precision. FP32 throughout, no TF32. Each step follows the torch code's
// order of operations: a product or sum that PyTorch runs as its own
// elementwise kernel is rounded on its own here (__fmul_rn, __fadd_rn,
// which nvcc does not contract into an FMA), a matrix product is one FMA
// chain over its inner index from 0 (as cuBLAS's FP32 kernels
// accumulate), a sum over the last axis adds left to right, a division by
// a Python scalar multiplies by its float reciprocal (PyTorch's CUDA
// division does), and the transcendental functions are the CUDA math
// library's (atan2f, tanf, expf, tanhf), as PyTorch's CUDA kernels call
// them. So the discrete decisions (the beam searched, radii, rect, det > 0,
// opacity > 0) agree with the torch path on all but a few rows.
//
// The walk: a block stages the heads (~6.7k floats) and the beam table in
// shared memory once, then walks tiles of kTile = 32 anchors:
//   * the tile's inputs [feat, ob_view, ob_dist] into shared memory; one
//     thread per anchor computes the view terms;
//   * the first layer as a register-tiled SIMT product (a thread holds 4
//     anchors x 4 units, the units one per head, so a warp reads 32
//     consecutive weights), the hidden units into shared memory, each head's
//     32 padded to 36 so that one anchor's four heads start in four bank
//     groups;
//   * the second layers, a thread per output column and 8 anchors, reading
//     the hidden units four at a time (one 16-byte load an anchor);
//   * the epilogue, one thread per gaussian row in the first seven warps:
//     the decode's activations, then the policy's row; consecutive threads
//     write consecutive 4F-byte rows. The last warp runs the prefilter of
//     the block's next tile meanwhile (a projection per anchor), so that
//     only a block's first tile waits for one.
// The grid holds as many blocks as the card keeps resident (the occupancy
// query), each walking tiles, so the heads are staged once a block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 32;                        // hidden units of a head
constexpr int kHeads = 4;                      // opacity, color, raydrop, cov
constexpr int kH1 = kHeads * kHd;              // the fused first layer
constexpr int kHPad = kHd + 4;                 // a head's units, padded: 16-byte rows
constexpr int kHStride = kHeads * kHPad + 4;   // an anchor's hidden row
constexpr int kTile = 32;                      // anchors a tile
constexpr int kThreads = 256;
constexpr int kExt = 12;                       // per anchor: xyz, exp(scaling) x6, vis
constexpr float kPi = 3.14159265358979323846f;

struct Heads {
  const float* w1[kHeads];
  const float* b1[kHeads];
  const float* w2[kHeads];
  const float* b2[kHeads];
};

struct Anchors {
  const float* anchor;
  const float* offset;
  const float* feat;
  const float* scaling;
  const float* rotation;
  const unsigned char* valid;
};

struct Frame {
  const float* rot;
  const float* trans;
  const float* center;
  const float* beams;
};

struct Out {
  float* pk;
  float* depth;
  unsigned char* valid;
  unsigned long long* n_valid;
};

struct Dims {
  int B, k, fd, d_in, H, grid_x;
  float near, far, lowpass, margin, col_pitch, inv_col, bx, by, inv_bx, inv_by, sentinel;
};

// Offsets (in floats) into the dynamic shared memory.
struct Layout {
  int dp, n2, w1, b1, w2, b2, beams, frame, x, h, ext, total;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout layout(int d_in, int k, int C, int H) {
  Layout L;
  L.dp = round4(d_in);
  L.n2 = (C + 8) * k;
  L.w1 = 0;
  L.b1 = L.dp * kH1;
  L.w2 = L.b1 + kH1;
  L.b2 = L.w2 + kHd * L.n2;
  L.beams = round4(L.b2 + L.n2);
  L.frame = round4(L.beams + H);
  L.x = L.frame + 16;                          // the inputs, later the second layers' outputs
  int xo = kTile * L.dp > kTile * (L.n2 + 1) ? kTile * L.dp : kTile * (L.n2 + 1);
  L.h = L.x + round4(xo);
  L.ext = L.h + round4(kTile * kHStride);
  L.total = L.ext + kTile * kExt + kTile;    // + the next tile's prefilter
  return L;
}

// One PyTorch elementwise operation each: rounded alone, never fused.
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// `(a * b).sum(-1)` over three columns: the products, then left to right.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fadd(fadd(fmul(a[0], b[0]), fmul(a[1], b[1])), fmul(a[2], b[2]));
}

// `v @ R.T` for a row v and a 3x3 R (row-major): one FMA chain from index 0.
__device__ __forceinline__ float mat_row(const float* v, const float* R, int j) {
  return fmaf(v[2], R[3 * j + 2], fmaf(v[1], R[3 * j + 1], fmul(v[0], R[3 * j])));
}

// torch.linalg.cross's kernel expression
__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// `projection.py` `quat_rotate_inv`: R(q)^T v = v + 2 (r uv + qv x uv),
// uv = qv x v, qv = -q[1:]
__device__ __forceinline__ void quat_rotate_inv(const float* q, const float* v, float* o) {
  const float qv[3] = {-q[1], -q[2], -q[3]};
  float uv[3], c[3];
  cross(qv, v, uv);
  cross(qv, uv, c);
  for (int i = 0; i < 3; ++i) o[i] = fadd(v[i], fmul(2.0f, fadd(fmul(q[0], uv[i]), c[i])));
}

// 1 / (1 + exp(-x)), PyTorch's CUDA sigmoid
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// `projection.py` `_project_rows` of one elevation: searchsorted(beams,
// alpha, side="left") with the index-0 branch; the fractional row (before
// the flip), the beam gap, and whether alpha lies within `margin` of its
// beam.
struct Elev {
  float row, gap;
  bool ok;
};

__device__ __forceinline__ Elev beam_row(float alpha, const float* beams, int H, float margin) {
  int lo = 0, hi = H;
  while (lo < hi) {
    const int md = (lo + hi) >> 1;
    if (beams[md] < alpha) lo = md + 1; else hi = md;
  }
  const int idx = lo < H - 1 ? lo : H - 1;
  const bool up = idx > 0;
  const float before = up ? beams[idx - 1] : beams[0];
  const float after = up ? beams[idx] : beams[1];
  Elev e;
  e.gap = fsub(after, before);
  e.row = up ? fadd((float)(idx - 1), fdiv(fsub(alpha, before), e.gap))
             : fadd(1.0f, fdiv(fsub(alpha, after), e.gap));
  e.ok = up ? alpha <= fadd(after, margin) : alpha >= fsub(before, margin);
  return e;
}

struct Row {
  float mean[3], u1[3], u2[3], conic[3], opacity, depth, rect[4], center[2];
  bool valid;
};

// `preprocess_gaussians` for one row. fr: w2s_rot [9], w2s_trans [3], the
// center [3], tan of the column pitch.
__device__ __forceinline__ Row project(const float* m, const float* s, const float* q, float opac, bool mask,
                       const float* fr, const float* beams, const Dims& d) {
  const float* R = fr;
  Row r;
  // p_view_raw = means @ R^T + t
  float p[3];
  for (int j = 0; j < 3; ++j) p[j] = fadd(mat_row(m, R, j), fr[9 + j]);
  mask = mask && dot3(p, p) > 0.0f;
  const float pv[3] = {mask ? p[0] : 1.0f, mask ? p[1] : 0.0f, mask ? p[2] : 0.0f};
  const float dist = sqrtf(dot3(pv, pv));
  bool valid = mask && dist < d.far && dist > d.near;

  // the micro cross-section basis
  const float safe = fmaxf(dist, 1e-12f);
  const float dn[3] = {fdiv(pv[0], safe), fdiv(pv[1], safe), fdiv(pv[2], safe)};
  const float horiz2 = fadd(fmul(dn[0], dn[0]), fmul(dn[1], dn[1]));
  const bool degen = horiz2 <= 0.0f;
  valid = valid && !degen;
  const float u1_len = sqrtf(degen ? 1.0f : horiz2);
  const float u1[3] = {fdiv(degen ? 1.0f : dn[1], u1_len), fdiv(degen ? 0.0f : -dn[0], u1_len),
                       fdiv(0.0f, u1_len)};
  float u2[3];
  cross(dn, u1, u2);

  // the projected 2x2 covariance
  float u1w[3], u2w[3], v1[3], v2[3];
  for (int j = 0; j < 3; ++j) {
    u1w[j] = fmaf(u1[2], R[6 + j], fmaf(u1[1], R[3 + j], fmul(u1[0], R[j])));
    u2w[j] = fmaf(u2[2], R[6 + j], fmaf(u2[1], R[3 + j], fmul(u2[0], R[j])));
  }
  quat_rotate_inv(q, u1w, v1);
  quat_rotate_inv(q, u2w, v2);
  for (int j = 0; j < 3; ++j) {
    v1[j] = fmul(v1[j], s[j]);
    v2[j] = fmul(v2[j], s[j]);
  }
  const float inv_d2 = fdiv(1.0f, fmaxf(fmul(dist, dist), 1e-20f));
  const float a = fmul(fadd(dot3(v1, v1), d.lowpass), inv_d2);
  const float b = fmul(dot3(v1, v2), inv_d2);
  const float c = fmul(fadd(dot3(v2, v2), d.lowpass), inv_d2);
  const float det = fsub(fmul(a, c), fmul(b, b));
  valid = valid && det > 0.0f;
  const float det_safe = det > 0.0f ? det : 1.0f;
  const float conic[3] = {fdiv(c, det_safe), fdiv(-b, det_safe), fdiv(a, det_safe)};
  const float mid = fmul(0.5f, fadd(a, c));
  const float lam = fadd(mid, sqrtf(fmaxf(fsub(fmul(mid, mid), det), 1e-9f)));
  const float sigma = sqrtf(fmaxf(lam, 1e-9f));

  // range-image coordinates
  const float pf[3] = {degen ? 1.0f : pv[0], degen ? 0.0f : pv[1], degen ? 0.0f : pv[2]};
  const float p_c = fmul(fsub(kPi, atan2f(pf[1], pf[0])), d.inv_col);
  const float horiz = sqrtf(degen ? 1.0f : fadd(fmul(pf[0], pf[0]), fmul(pf[1], pf[1])));
  const float alpha = atan2f(pf[2], horiz);
  const Elev el = beam_row(alpha, beams, d.H, d.margin);
  valid = valid && el.ok;
  const float p_r = fsub(fsub((float)d.H, el.row), 1.0f);
  const float r_y = ceilf(fdiv(fmul(3.0f, sigma), tanf(fabsf(el.gap))));
  const float r_x = ceilf(fdiv(fmul(3.0f, sigma), fr[15]));

  // the reference's tile rect, in pixel units
  const float gx = (float)d.grid_x, Hf = (float)d.H;
  const float rmin_x = clampf(floorf(fmul(fsub(p_c, r_x), d.inv_bx)), 0.0f, gx);
  const float rmax_x =
      clampf(floorf(fmul(fsub(fadd(fadd(p_c, r_x), d.bx), 1.0f), d.inv_bx)), 0.0f, gx);
  const float rmin_y = clampf(floorf(fadd(fmul(fsub(p_r, r_y), d.inv_by), 0.5f)), 0.0f, Hf);
  const float rmax_y = clampf(fmaxf(floorf(fadd(fadd(p_r, fmul(r_y, d.inv_by)), 0.5f)),
                                    fadd(floorf(fadd(fmul(p_r, d.inv_by), 0.5f)), 1.0f)),
                              0.0f, Hf);
  valid = valid && fmul(fsub(rmax_x, rmin_x), fsub(rmax_y, rmin_y)) > 0.0f;

  for (int i = 0; i < 3; ++i) {
    r.mean[i] = dn[i];
    r.u1[i] = u1[i];
    r.u2[i] = u2[i];
    r.conic[i] = valid ? conic[i] : 0.0f;
  }
  r.opacity = valid ? opac : 0.0f;
  r.depth = valid ? dist : d.sentinel;
  r.rect[0] = fmul(rmin_x, d.bx);
  r.rect[1] = fmul(rmax_x, d.bx);
  r.rect[2] = fmul(rmin_y, d.by);
  r.rect[3] = fmul(rmax_y, d.by);
  r.center[0] = p_c;
  r.center[1] = p_r;
  r.valid = valid;
  return r;
}

// The prefilter's verdict on anchor `ag` (`prefilter_anchors`): live, and
// visible when projected with exp(scaling[:3]) and q / max(|q|, 1e-12).
__device__ __forceinline__ bool prefilter(const Anchors& in, int ag, const float* fr,
                                          const float* beams, const Dims& d) {
  if (!in.valid[ag]) return false;
  const float* an = in.anchor + 3 * ag;
  const float sc[3] = {expf(in.scaling[6 * ag]), expf(in.scaling[6 * ag + 1]),
                       expf(in.scaling[6 * ag + 2])};
  const float* qr = in.rotation + 4 * ag;
  const float n = fmaxf(sqrtf(fadd(fadd(fadd(fmul(qr[0], qr[0]), fmul(qr[1], qr[1])),
                                        fmul(qr[2], qr[2])),
                                   fmul(qr[3], qr[3]))),
                        1e-12f);
  const float qn[4] = {fdiv(qr[0], n), fdiv(qr[1], n), fdiv(qr[2], n), fdiv(qr[3], n)};
  return project(an, sc, qn, 1.0f, true, fr, beams, d).valid;
}

// One decoded gaussian (`generate_neural_gaussians`' row): the tanh
// opacity, the C channels, the cov scales, the normalized quaternion, the
// world mean and mask = valid & visible & (opacity > 0).
template <int C>
struct Gaussian {
  float op, col[C], scl[3], rot[4], xyz[3];
  bool mask;
};

// The front of the anchor rows [0, B): the walk above, `Pack`'s row for
// every gaussian.
template <int C, class Pack>
__global__ void __launch_bounds__(kThreads, Pack::kBlocks)
    front_kernel(Anchors in, Heads hw, Frame fm, Out out, Dims d, Pack pack) {
  constexpr int F = ((21 + C) + 7) / 8 * 8;
  extern __shared__ __align__(16) float smem[];
  const int k = d.k;
  const Layout L = layout(d.d_in, k, C, d.H);
  const int n2 = L.n2, dp = L.dp;
  float* w1s = smem + L.w1;
  float* b1s = smem + L.b1;
  float* w2s = smem + L.w2;
  float* b2s = smem + L.b2;
  float* beams = smem + L.beams;
  float* fr = smem + L.frame;
  float* xs = smem + L.x;
  float* os = smem + L.x;                      // the inputs are dead once the first layer ran
  float* hs = smem + L.h;
  float* ext = smem + L.ext;
  float* vis_next = ext + kTile * kExt;        // the prefilter of the block's next tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the second layers' column ranges: opacity, color, raydrop, cov
  const int c1 = k, c2 = k * C, c3 = k * (C + 1);

  // --- the heads, the beam table and the frame, once a block ---
  for (int e = tid; e < dp * kH1; e += kThreads) {
    const int dd = e / kH1, col = e - dd * kH1, hd = col / kHd, u = col - hd * kHd;
    w1s[e] = dd < d.d_in ? hw.w1[hd][dd * kHd + u] : 0.0f;
  }
  for (int e = tid; e < kH1; e += kThreads) b1s[e] = hw.b1[e / kHd][e % kHd];
  for (int e = tid; e < kHd * n2; e += kThreads) {
    const int u = e / n2, o = e - u * n2;
    const int hd = o < c1 ? 0 : o < c2 ? 1 : o < c3 ? 2 : 3;
    const int base = hd == 0 ? 0 : hd == 1 ? c1 : hd == 2 ? c2 : c3;
    const int width = hd == 0 ? k : hd == 1 ? c2 - c1 : hd == 2 ? k : 7 * k;
    w2s[e] = hw.w2[hd][u * width + (o - base)];
    if (u == 0) b2s[o] = hw.b2[hd][o - base];
  }
  for (int e = tid; e < d.H; e += kThreads) beams[e] = fm.beams[e];
  if (tid < 9) fr[tid] = fm.rot[tid];
  if (tid >= 9 && tid < 12) fr[tid] = fm.trans[tid - 9];
  if (tid >= 12 && tid < 15) fr[tid] = fm.center[tid - 12];
  if (tid == 15) fr[15] = tanf(d.col_pitch);

  unsigned count = 0;
  const int n_tiles = (d.B + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int a0 = tile * kTile;
    __syncthreads();                           // the staging above, or the last tile's epilogue
    // --- the tile's inputs ---
    for (int e = tid; e < kTile * d.fd; e += kThreads) {
      const int a = e / d.fd, cc = e - a * d.fd;
      xs[a * dp + cc] = a0 + a < d.B ? in.feat[(long long)(a0 + a) * d.fd + cc] : 0.0f;
    }
    if (tid < kTile) {
      const int ag = a0 + tid;
      float* xa = xs + tid * dp;
      float* ea = ext + tid * kExt;
      for (int i = d.fd; i < dp; ++i) xa[i] = 0.0f;
      if (ag < d.B) {
        const float an[3] = {in.anchor[3 * ag], in.anchor[3 * ag + 1], in.anchor[3 * ag + 2]};
        // ob_view, ob_dist with the zero-distance guard
        const float ov[3] = {fsub(an[0], fr[12]), fsub(an[1], fr[13]), fsub(an[2], fr[14])};
        const float d2 = dot3(ov, ov);
        const bool ok = d2 > 0.0f;
        const float od = sqrtf(ok ? d2 : 1.0f);
        for (int i = 0; i < 3; ++i) xa[d.fd + i] = fdiv(ok ? ov[i] : 0.0f, od);
        if (d.d_in > d.fd + 3) xa[d.fd + 3] = od;
        float sc[6];
        for (int i = 0; i < 6; ++i) sc[i] = expf(in.scaling[6 * ag + i]);
        for (int i = 0; i < 3; ++i) ea[i] = an[i];
        for (int i = 0; i < 6; ++i) ea[3 + i] = sc[i];
        const bool vis = tile == blockIdx.x ? prefilter(in, ag, fr, beams, d)
                                            : vis_next[tid] != 0.0f;
        ea[9] = vis ? 1.0f : 0.0f;
      } else {
        for (int i = 0; i < kExt; ++i) ea[i] = 0.0f;
        for (int i = d.fd; i < d.d_in; ++i) xa[i] = 0.0f;
      }
    }
    __syncthreads();

    // --- the fused first layer: anchors 4w..4w+3, unit `lane` of each head ---
    {
      float acc[4][kHeads];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < kHeads; ++j) acc[i][j] = 0.0f;
      const float* xr = xs + warp * 4 * dp;
      for (int d0 = 0; d0 < dp; d0 += 4) {
        float4 xv[4];
        for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * dp + d0);
        for (int dd = 0; dd < 4; ++dd) {
          float w[kHeads];
          for (int j = 0; j < kHeads; ++j) w[j] = w1s[(d0 + dd) * kH1 + j * kHd + lane];
          for (int i = 0; i < 4; ++i) {
            const float xi = dd == 0 ? xv[i].x : dd == 1 ? xv[i].y : dd == 2 ? xv[i].z : xv[i].w;
            for (int j = 0; j < kHeads; ++j) acc[i][j] = fmaf(xi, w[j], acc[i][j]);
          }
        }
      }
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < kHeads; ++j)
          hs[(warp * 4 + i) * kHStride + j * kHPad + lane] =
              fmaxf(fadd(acc[i][j], b1s[j * kHd + lane]), 0.0f);
    }
    __syncthreads();

    // --- the second layers: column o, anchors 8g..8g+7 ---
    {
      const int g = tid >> 6;
      for (int o = tid & 63; o < n2; o += 64) {
        const int hd = o < c1 ? 0 : o < c2 ? 1 : o < c3 ? 2 : 3;
        const float* hr = hs + g * 8 * kHStride + hd * kHPad;
        float acc[8];
        for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
        for (int u = 0; u < kHd; u += 4) {
          const float w0 = w2s[u * n2 + o], w1 = w2s[(u + 1) * n2 + o];
          const float w2 = w2s[(u + 2) * n2 + o], w3 = w2s[(u + 3) * n2 + o];
          for (int i = 0; i < 8; ++i) {
            const float4 hv = *reinterpret_cast<const float4*>(hr + i * kHStride + u);
            acc[i] = fmaf(hv.w, w3, fmaf(hv.z, w2, fmaf(hv.y, w1, fmaf(hv.x, w0, acc[i]))));
          }
        }
        for (int i = 0; i < 8; ++i) os[(g * 8 + i) * (n2 + 1) + o] = fadd(acc[i], b2s[o]);
      }
    }
    __syncthreads();

    // --- the epilogue: one gaussian row a thread of the first seven warps;
    // the last warp runs the prefilter of the block's next tile meanwhile ---
    if (warp == kThreads / 32 - 1) {
      const int an = (tile + gridDim.x) * kTile + lane;
      if (tile + gridDim.x < n_tiles)
        vis_next[lane] = an < d.B && prefilter(in, an, fr, beams, d) ? 1.0f : 0.0f;
    }
    for (int r = tid; warp < kThreads / 32 - 1 && r < kTile * k; r += kThreads - 32) {
      const int a = r / k, j = r - a * k;
      if (a0 + a >= d.B) break;
      const float* o = os + a * (n2 + 1);
      const float* ea = ext + a * kExt;
      Gaussian<C> g;
      g.op = tanhf(o[j]);
      for (int cc = 0; cc < C - 1; ++cc) g.col[cc] = sigmoid(o[c1 + j * (C - 1) + cc]);
      g.col[C - 1] = sigmoid(o[c2 + j]);
      const float* sr = o + c3 + 7 * j;
      g.scl[0] = fmul(ea[6], sigmoid(sr[0]));
      g.scl[1] = fmul(ea[7], sigmoid(sr[1]));
      g.scl[2] = fmul(ea[8], sigmoid(sr[2]));
      const float qn2 = fadd(fadd(fadd(fmul(sr[3], sr[3]), fmul(sr[4], sr[4])),
                                  fmul(sr[5], sr[5])),
                             fmul(sr[6], sr[6]));
      const bool pos = qn2 > 0.0f;
      const float qn = sqrtf(pos ? qn2 : 1.0f);
      g.rot[0] = fdiv(pos ? sr[3] : 1.0f, qn);
      g.rot[1] = fdiv(pos ? sr[4] : 0.0f, qn);
      g.rot[2] = fdiv(pos ? sr[5] : 0.0f, qn);
      g.rot[3] = fdiv(pos ? sr[6] : 0.0f, qn);
      const long long row = (long long)(a0 + a) * k + j;
      const float* off = in.offset + 3 * row;
      g.xyz[0] = fadd(ea[0], fmul(off[0], ea[3]));
      g.xyz[1] = fadd(ea[1], fmul(off[1], ea[4]));
      g.xyz[2] = fadd(ea[2], fmul(off[2], ea[5]));
      g.mask = ea[9] != 0.0f && g.op > 0.0f;

      float v[F];
      const bool valid = pack.template row<C, F>(g, fr, beams, d, v);
      float4* dst = reinterpret_cast<float4*>(out.pk + row * F);
      for (int i = 0; i < F / 4; ++i)
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      out.depth[row] = v[13];
      out.valid[row] = valid ? 1 : 0;
      count += valid ? 1u : 0u;
    }
  }

  // the valid rows: a warp sum, then one atomic a block
  __shared__ unsigned block_count;
  if (tid == 0) block_count = 0;
  __syncthreads();
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0 && count) atomicAdd(&block_count, count);
  __syncthreads();
  if (tid == 0 && block_count) atomicAdd(out.n_valid, (unsigned long long)block_count);
}

// The grid of a launch: the card's resident blocks of this kernel at this
// shared memory, found once per (device, C, Pack, bytes).
template <int C, class Pack>
cudaError_t launch(const Anchors& in, const Heads& hw, const Frame& fm, const Out& out,
                   const Dims& d, const Pack& pack, int smem_bytes, cudaStream_t stream) {
  static int cached_dev = -1, cached_bytes = -1, cached_blocks = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem_bytes != cached_bytes) {
    int optin = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
      return err;
    if (smem_bytes + 64 > optin) return cudaErrorInvalidValue;   // + the block's counter
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
    if ((err = cudaFuncSetAttribute(front_kernel<C, Pack>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes)))
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, front_kernel<C, Pack>,
                                                             kThreads, smem_bytes)))
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_bytes = smem_bytes;
    cached_blocks = sms * per_sm;
  }
  const int n_tiles = (d.B + kTile - 1) / kTile;
  const int grid = n_tiles < cached_blocks ? n_tiles : cached_blocks;
  front_kernel<C, Pack><<<grid, kThreads, smem_bytes, stream>>>(in, hw, fm, out, d, pack);
  return cudaGetLastError();
}

// The launch of `Pack`'s front from the C interface's arguments: the
// checks of the arguments, the structs, the instance for C.
template <class Pack>
int launch_front(const float* anchor, const float* offset, const float* feat,
                 const float* scaling, const float* rotation, const unsigned char* valid,
                 const float* const* head_ptrs, const float* w2s_rot, const float* w2s_trans,
                 const float* center, const float* beams, float* pk, float* depth,
                 unsigned char* valid_out, long long* n_valid, int B, int k, int fd, int d_in,
                 int C, int H, int W, int bx, int by, float near, float far, float lowpass,
                 float margin, float col_pitch, float inv_col, float inv_bx, float inv_by,
                 float sentinel, const Pack& pack, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (k < 1 || H < 2 || W < 1 || bx < 1 || by < 1 || d_in < fd + 3 || d_in > fd + 4)
    return (int)cudaErrorInvalidValue;
  const Anchors in{anchor, offset, feat, scaling, rotation, valid};
  const float* const* p = head_ptrs;   // per head: l1 w, l1 b, l2 w, l2 b
  const Heads hw{{p[0], p[4], p[8], p[12]},
                 {p[1], p[5], p[9], p[13]},
                 {p[2], p[6], p[10], p[14]},
                 {p[3], p[7], p[11], p[15]}};
  const Frame fm{w2s_rot, w2s_trans, center, beams};
  const Out out{pk, depth, valid_out, reinterpret_cast<unsigned long long*>(n_valid)};
  const Dims d{B, k, fd, d_in, H, (W + bx - 1) / bx, near, far, lowpass, margin, col_pitch,
               inv_col, (float)bx, (float)by, inv_bx, inv_by, sentinel};
  const int smem = layout(d_in, k, C, H).total * (int)sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(in, hw, fm, out, d, pack, smem, s);
    case 2: return (int)launch<2>(in, hw, fm, out, d, pack, smem, s);
    case 3: return (int)launch<3>(in, hw, fm, out, d, pack, smem, s);
    case 4: return (int)launch<4>(in, hw, fm, out, d, pack, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
