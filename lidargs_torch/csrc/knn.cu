// Nearest-neighbour distances (kernels N1, N2 and N3) for Hopper (sm_90a).
//
// One kernel template over a query set q and a point set p, in three
// instances, each the counterpart of compiled code of the JAX package:
//
//   N1 `lidargs_knn_chamfer` replaces `_chamfer_dir` of lidargs_tpu/ops/knn.py
//      (a jitted Gram-form program; the reference's chamfer3D.cu):
//        for each valid query row q_i: min_j (|p_j|^2 - 2 q_i.p_j) over the
//        valid p_j, then + |q_i|^2, then max(., 0); 0 where q_i is invalid,
//        +inf for a valid q_i when no p_j is valid.
//   N2 `lidargs_knn_gram_topk` replaces `_chunk_knn_sqdist` of the same file
//      (jitted; the reference's simple_knn distCUDA2):
//        the kk <= 8 smallest of (|p_j|^2 - 2 q_i.p_j) over every j (the
//        query itself included), ascending, each + |q_i|^2.
//   N3 `lidargs_knn3_direct` replaces `knn3_mean_sq_dist` of
//      lidargs_tpu/native/lidargs_native.cpp (a C++ grid hash), on one set
//      (q = p):
//        each d2 = (dx*dx + dy*dy) + dz*dz of the float32 differences, each
//        step rounded alone (no FMA); the point itself excluded by index (a
//        duplicate counts at 0); the three smallest summed in ascending
//        order, (b0 + b1) + b2, over min(3, n - 1) of them, and divided by 3.
//
// The norms |q|^2 and |p|^2 are computed by the caller exactly as the plain
// versions compute them (lidargs_torch/ops/knn.py), with +inf on an invalid
// p row for N1; the kernel reads them. Adding |q_i|^2 after the minimum is
// the plain versions' order: rounding is monotone, so the minimum's value is
// the same. Only the per-pair dot product and the -2 step round differently
// from cuBLAS's addmm: the point rows are staged as (-2 x, -2 y, -2 z,
// |p|^2) (the scaling by -2 is exact) and a pair costs three FMAs. No tensor
// cores: TF32 would move the Gram form by metres at street range. The
// minimum and the top-k are exact, so two launches give the same bits, and
// N3 gives the plain version's bits.
//
// What bounds it on an H100: the pairs. A frame of the evaluation has at
// most 64 x 2650 = 169,600 points on each side, 2.9e10 pairs a direction
// at 7 FP32 operations each (three multiplies and three adds of the Gram
// value, one compare): ~3 ms a direction at 67 TFLOP/s, against ~2 MB of
// points and distances (~1 us at 3.35 TB/s). N3 at 500,000 points is 2.5e11
// pairs at 9 operations (three subtracts, three multiplies, two adds, one
// compare): ~34 ms. So all three are bound by operations.
//
// Design (simple first; a grid hash or a split of the point set across
// blocks is later work):
//   * one thread per query row, kThreads rows a block;
//   * the point set streamed through shared memory in stages of kTile
//     float4 rows, every thread reading each row by broadcast;
//   * the minimum (N1), or the k smallest in ascending order (N2, N3),
//     kept in registers by a sorted insertion that runs only when a value
//     beats the current k-th;
//   * N3 excludes the query row by index only in the one stage that holds
//     the block's own rows (kTile is a multiple of kThreads), so the other
//     stages pay no index compare;
//   * rows past the end of the set are staged as +inf distances.
// No float atomics, no reduction across threads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // query rows a block, one a thread
constexpr int kTile = 1024;     // point rows a shared-memory stage (16 KB of float4)
constexpr int kMaxK = 8;        // the most smallest values N2 keeps
static_assert(kTile % kThreads == 0, "a block's rows must lie in one stage");

enum Mode : int { kChamfer = 0, kGramTopK = 1, kDirect3 = 2 };

template <int kMode>
struct Slots {
  static constexpr int value = kMode == kChamfer ? 1 : (kMode == kGramTopK ? kMaxK : 3);
};

struct Args {
  const float* q;          // [nq, 3] query rows (N3: p)
  const float* q2;         // [nq] |q|^2 (N1, N2)
  const uint8_t* q_valid;  // [nq] (N1)
  const float* p;          // [np, 3] point rows
  const float* p2;         // [np] |p|^2, +inf on an invalid row (N1, N2)
  float* out;              // N1 [nq], N2 [nq, kk], N3 [nq]
  int nq, np, kk;
};

// |p|^2 - 2 q.p from a staged row (-2 p, |p|^2): three FMAs
__device__ __forceinline__ float gram(float qx, float qy, float qz, float4 s) {
  return fmaf(qx, s.x, fmaf(qy, s.y, fmaf(qz, s.z, s.w)));
}

// ((dx*dx + dy*dy) + dz*dz) of the float32 differences, each step rounded
// alone, as the plain version's separate tensor ops and the native loop do
__device__ __forceinline__ float direct(float qx, float qy, float qz, float4 s) {
  const float dx = __fsub_rn(s.x, qx), dy = __fsub_rn(s.y, qy), dz = __fsub_rn(s.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// v into the ascending best[0..K), the largest dropped
template <int K>
__device__ __forceinline__ void insert(float (&best)[K], float v) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float lo = fminf(best[t], v);
    v = fmaxf(best[t], v);
    best[t] = lo;
  }
}

// best[k] for a k known only at run time, without indexing registers
template <int K>
__device__ __forceinline__ float pick(const float (&best)[K], int k) {
  float r = CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < K; ++t)
    if (t == k) r = best[t];
  return r;
}

template <int kMode>
__device__ __forceinline__ void update(float (&best)[Slots<kMode>::value], float& thresh,
                                       int kk, float v) {
  if constexpr (kMode == kChamfer) {
    best[0] = fminf(best[0], v);
  } else if constexpr (kMode == kGramTopK) {
    if (v < thresh) {
      insert(best, v);
      thresh = pick(best, kk - 1);
    }
  } else {
    if (v < best[2]) insert(best, v);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) knn_kernel(Args a) {
  constexpr int K = Slots<kMode>::value;
  constexpr bool kGram = kMode != kDirect3;
  __shared__ float4 stage[kTile];

  const int row0 = blockIdx.x * kThreads;
  const int i = row0 + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < a.nq) {
    const float* qi = a.q + 3 * static_cast<size_t>(i);
    qx = qi[0];
    qy = qi[1];
    qz = qi[2];
  }
  float best[K];
#pragma unroll
  for (int t = 0; t < K; ++t) best[t] = CUDART_INF_F;
  float thresh = a.kk > 0 ? CUDART_INF_F : -CUDART_INF_F;   // N2: best[kk - 1]
  const int self_base = row0 / kTile * kTile;               // N3: the stage of this block's rows

  for (int base = 0; base < a.np; base += kTile) {
    __syncthreads();                                        // every thread has read the last stage
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
      const int j = base + t;
      float4 s;
      if (j < a.np) {
        const float* pj = a.p + 3 * static_cast<size_t>(j);
        if constexpr (kGram)
          s = make_float4(-2.f * pj[0], -2.f * pj[1], -2.f * pj[2], a.p2[j]);
        else
          s = make_float4(pj[0], pj[1], pj[2], 0.f);
      } else if constexpr (kGram) {
        s = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      } else {
        s = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
      }
      stage[t] = s;
    }
    __syncthreads();
    if (kMode == kDirect3 && base == self_base) {
      // the stage that holds the query row: excluded by its index
      for (int t = 0; t < kTile; ++t) {
        const float v = base + t == i ? CUDART_INF_F : direct(qx, qy, qz, stage[t]);
        update<kMode>(best, thresh, a.kk, v);
      }
    } else {
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float4 s = stage[t];
        update<kMode>(best, thresh, a.kk, kGram ? gram(qx, qy, qz, s) : direct(qx, qy, qz, s));
      }
    }
  }
  if (i >= a.nq) return;

  if constexpr (kMode == kChamfer) {
    const float m = __fadd_rn(best[0], a.q2[i]);
    a.out[i] = a.q_valid[i] ? fmaxf(m, 0.f) : 0.f;
  } else if constexpr (kMode == kGramTopK) {
    const float q2 = a.q2[i];
    float* o = a.out + static_cast<size_t>(i) * a.kk;
#pragma unroll
    for (int t = 0; t < K; ++t)
      if (t < a.kk) o[t] = __fadd_rn(best[t], q2);
  } else {
    const int k = min(3, a.np - 1);
    float acc = 0.f;
    if (k >= 1) acc = best[0];
    if (k >= 2) acc = __fadd_rn(acc, best[1]);
    if (k >= 3) acc = __fadd_rn(acc, best[2]);
    a.out[i] = __fdiv_rn(acc, 3.f);
  }
}

template <int kMode>
int launch(const Args& a, void* stream) {
  const int blocks = (a.nq + kThreads - 1) / kThreads;
  knn_kernel<kMode><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches N1 on `stream`: out[i] for the na rows of a against the nb rows
// of b; returns the cudaError_t of the launch (0 = ok). The caller has
// checked shapes, types, contiguity and the device, and that na > 0.
int lidargs_knn_chamfer(const float* a, const float* a2, const uint8_t* a_valid,
                        const float* b, const float* b2, float* out, int na, int nb,
                        void* stream) {
  return launch<kChamfer>(Args{a, a2, a_valid, b, b2, out, na, nb, 1}, stream);
}

// Launches N2 on `stream`: out [nq, kk], the kk (1..8, <= np) smallest
// squared distances of each query row, ascending. The caller has checked
// shapes, types, contiguity, the device and kk, and that nq > 0.
int lidargs_knn_gram_topk(const float* q, const float* q2, const float* p, const float* p2,
                          float* out, int nq, int np, int kk, void* stream) {
  return launch<kGramTopK>(Args{q, q2, nullptr, p, p2, out, nq, np, kk}, stream);
}

// Launches N3 on `stream`: out [n], each point's mean squared distance to
// its 3 nearest others. The caller has checked shape, type, contiguity and
// the device, and that n > 0.
int lidargs_knn3_direct(const float* p, float* out, int n, void* stream) {
  return launch<kDirect3>(Args{p, nullptr, nullptr, p, nullptr, out, n, n, 3}, stream);
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
