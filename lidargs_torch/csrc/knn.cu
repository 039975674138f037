// Nearest-neighbour distances (kernels N1, N2 and N3) for Hopper (sm_90a).
//
// Three kernels over a query set q and a point set p, each the counterpart of
// compiled code of the JAX package:
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
//        step rounded alone (no FMA); the point itself excluded (a
//        duplicate counts at 0); the three smallest summed in ascending
//        order, (b0 + b1) + b2, over min(3, n - 1) of them, and divided by 3.
//
// The norms |q|^2 and |p|^2 are computed by the caller exactly as the plain
// versions compute them (lidargs_torch/ops/knn.py). For N1 and N2 the caller
// also packs the point set once a call into float4 rows (-2 x, -2 y, -2 z,
// |p|^2) (the scaling by -2 is exact; +inf norms on N1's invalid rows), cut
// into `cluster` slices of `slice` rows each, the rows past the set padded
// with (0, 0, 0, +inf), which no minimum or k-list takes
// (lidargs_torch/ops/knn_kernel.py `pack_points`); for N3 it packs the
// rows (x, y, z, 0), the rows past the set +inf. A Gram pair costs three
// FMAs, fmaf(qx, sx, fmaf(qy, sy, fmaf(qz, sz, sw))). Adding |q_i|^2 after the
// minimum is the plain versions' order: rounding is monotone, so the
// minimum's value is the same. Only the per-pair dot product and the -2 step
// round differently from cuBLAS's addmm. No tensor cores: TF32 would move the
// Gram form by metres at street range. The minimum and the k smallest are
// exact and independent of the order the pairs are taken in, so any split of
// the work gives the same bits, two launches give the same bits, and N3
// gives the plain version's bits.
//
// What bounds them on an H100: the pairs. A frame of the evaluation has at
// most 64 x 2650 = 169,600 points on each side, 2.9e10 pairs a direction
// at 7 FP32 operations each (three multiplies and three adds of the Gram
// value, one compare): ~3 ms a direction at 67 TFLOP/s, against ~2 MB of
// points and distances (~1 us at 3.35 TB/s). N3 at 500,000 points is 2.5e11
// pairs at 9 operations (three subtracts, three multiplies, two adds, one
// compare): ~34 ms. So all three are bound by operations. A Gram pair needs
// 3 FFMA + 1 FMNMX issue slots (the bound counts 3.5), a direct pair 8
// FADD / FMUL + 1 FMNMX (the bound counts 4.5: none of them is an FMA), so
// the design aims to issue nothing else a pair.
//
// N1, N2 and N3 (`sweep_kernel`, one scaffold):
//   * each thread keeps R adjacent query rows in registers (N2: R sorted
//     k-lists), a block kThreads * R adjacent rows, so a staged point read
//     from shared memory (one LDS.128, a broadcast) serves R pairs and the
//     loop carries R independent chains; rows stay in the caller's order.
//     R is 8 for N1 and 4 for N2 and N3, whose k-lists take the registers
//     (measured, utils/kernel_ab.py);
//   * a thread-block cluster of S blocks takes the same rows, each block
//     sweeping one slice of the point set. After `cluster.sync()` block
//     rank 0 reads its partners' minima (N1) or k-lists (N2, N3) from their
//     shared memory (`map_shared_rank`), merges them and writes the output:
//     one launch, no scratch tensor, no atomics. One block of R * kThreads
//     rows a cluster would leave the SMs idle: N1's ~161k rows make ~158
//     such blocks for 132 SMs. The launch plan (ops/knn_kernel.py
//     `launch_plan`) takes the S that fills the SMs' resident blocks in the
//     fullest waves; N2 and N3 at most 2, since each slice warms its k-lists
//     up from +inf and its insertions grow with S;
//   * a block streams its slice through a two-stage ring in shared memory,
//     kStageRows float4 rows a stage, by one bulk copy each (fwd_stage.cuh:
//     one elected thread, completing on the stage's mbarrier), stage c + 1
//     landing while the block works on stage c;
//   * N2 and N3 keep each row's k-list sorted by a network of fminf / fmaxf
//     that runs only where a value beats the list's last (the k-th
//     smallest). The kGroup values of a row from one group of staged points
//     are tested at once, their minimum against the k-th smallest, and the
//     offers run behind that one test (a test a pair ran 2.5x slower);
//   * N3 pays no index compare for the query row itself: it keeps the K = 4
//     smallest values with the row's own distance among them and drops the
//     first. That distance is exactly +0 (q - q rounds to +0, and no
//     distance is below it), so it is the list's first value, or a
//     duplicate's equal +0 is; the other three are then the three smallest
//     of the row's others, duplicates at 0 included, summed in ascending
//     order as the plain version sums its top-3 by index exclusion.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "fwd_stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kMaxK = 8;        // the most smallest values N2 keeps a row
constexpr int kMaxCluster = 8;  // blocks a cluster: the portable cluster size
constexpr int kRowsChamfer = 8; // R of N1: query rows a thread
constexpr int kRowsTopK = 4;    // R of N2 (its K-lists take the registers of the rest)
constexpr int kRowsDirect = 4;  // R of N3
constexpr int kDirectK = 4;     // N3's list: the three nearest and the row itself
constexpr int kStageRows = 256; // packed rows a stage (4 KB of float4)
constexpr int kGroup = 8;       // packed rows a thread takes from a stage at once
static_assert(kStageRows % kGroup == 0, "a stage holds whole groups");

// the sweep's modes (its third template argument)
constexpr int kTopK = 0;        // N2: the K smallest Gram values
constexpr int kChamfer = 1;     // N1: the smallest Gram value of the valid points
constexpr int kDirect3 = 2;     // N3: the 3-NN mean by direct differences

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

// N2, N3: v into the sorted k-list if it beats the k-th smallest
template <int K>
__device__ __forceinline__ void offer(float (&best)[K], float v) {
  if (v < best[K - 1]) insert(best, v);
}

struct SweepArgs {
  const float* q;          // [nq, 3] query rows (N3: the set itself)
  const float* q2;         // [nq] |q|^2 (N1, N2)
  const uint8_t* q_valid;  // [nq] (N1)
  const float4* packed;    // [cluster * slice] staged point rows, padded: N1 / N2
                           // (-2 p, |p|^2), N3 (p, 0)
  float* out;              // N1, N3 [nq], N2 [nq, K]
  int nq;
  int slice;               // packed rows a cluster rank sweeps, a multiple of kGroup
};

// N1 (K = 1, kChamfer), N2 (the K smallest, kTopK) and N3 (kDirect3, K =
// 4), R query rows a thread, the point set split over the blocks of a
// cluster.
template <int K, int R, int kMode>
__global__ void __launch_bounds__(kThreads) sweep_kernel(SweepArgs a) {
  static_assert(kMode != kDirect3 || K == kDirectK, "N3 keeps the row itself and three others");
  __shared__ __align__(128) float4 ring[2][kStageRows];  // the stages
  __shared__ uint64_t full[2];                           // each stage's barrier
  __shared__ float partial[K * R * kThreads];            // a rank's lists, for rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / n_ranks) * (kThreads * R) + tid * R;

  float qx[R], qy[R], qz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qx[r] = qy[r] = qz[r] = 0.f;
    if (row0 + r < a.nq) {
      const float* qi = a.q + 3 * static_cast<size_t>(row0 + r);
      qx[r] = qi[0];
      qy[r] = qi[1];
      qz[r] = qi[2];
    }
  }
  float best[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) best[r][k] = CUDART_INF_F;

  // the slice: whole groups; every stage but the last holds kStageRows rows
  const float4* src = a.packed + static_cast<size_t>(rank) * a.slice;
  const int n_stages = (a.slice + kStageRows - 1) / kStageRows;
  auto stage_rows = [&](int c) { return min(kStageRows, a.slice - c * kStageRows); };
  if (tid == 0) lidargs::stage_init(full);
  __syncthreads();
  if (tid == 0 && n_stages > 0) lidargs::stage_load(ring[0], src, stage_rows(0) * 16, &full[0]);
  for (int c = 0; c < n_stages; ++c) {
    const int s = c & 1;
    // stage c + 1 into the other buffer, which every thread finished
    // reading before the barrier that ended stage c - 1
    if (tid == 0 && c + 1 < n_stages)
      lidargs::stage_load(ring[s ^ 1], src + static_cast<size_t>(c + 1) * kStageRows,
                          stage_rows(c + 1) * 16, &full[s ^ 1]);
    lidargs::stage_wait(&full[s], (c >> 1) & 1);
    const float4* st = ring[s];
    const int rows = stage_rows(c);
    for (int t = 0; t < rows; t += kGroup) {
      float4 p[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) p[g] = st[t + g];
      if constexpr (kMode == kChamfer) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            best[r][0] = fminf(best[r][0], gram(qx[r], qy[r], qz[r], p[g]));
      } else {
        // each row's kGroup values tested at once: their minimum against
        // the k-th smallest, the offers (each its own compare) behind it
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            v[g] = kMode == kDirect3 ? direct(qx[r], qy[r], qz[r], p[g])
                                     : gram(qx[r], qy[r], qz[r], p[g]);
          float m = v[0];
#pragma unroll
          for (int g = 1; g < kGroup; ++g) m = fminf(m, v[g]);
          if (m < best[r][K - 1]) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g) offer(best[r], v[g]);
          }
        }
      }
    }
    __syncthreads();  // every thread has read stage c before stage c + 2 refills it
  }

  if (n_ranks > 1) {
    // rank 0 merges the partners' lists: the k smallest of the union are
    // the same values whatever the slices and the order
    if (rank != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < K; ++k) partial[(k * R + r) * kThreads + tid] = best[r][k];
    }
    cluster.sync();
    if (rank == 0) {
      for (int other = 1; other < n_ranks; ++other) {
        const float* theirs = cluster.map_shared_rank(&partial[0], other);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float v = theirs[(k * R + r) * kThreads + tid];
            if constexpr (kMode == kChamfer)
              best[r][0] = fminf(best[r][0], v);
            else
              offer(best[r], v);
          }
      }
    }
    cluster.sync();  // a partner's shared memory lives until rank 0 has read it
  }
  if (rank != 0) return;

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= a.nq) break;
    if constexpr (kMode == kChamfer) {
      const float m = __fadd_rn(best[r][0], a.q2[i]);
      a.out[i] = a.q_valid[i] ? fmaxf(m, 0.f) : 0.f;
    } else if constexpr (kMode == kDirect3) {
      // best[r][0] is the row's own +0 (or a duplicate's equal +0); the
      // min(3, n - 1) values after it are the nearest others, ascending
      const int k = min(K - 1, a.nq - 1);
      float acc = 0.f;
      if (k >= 1) acc = best[r][1];
      if (k >= 2) acc = __fadd_rn(acc, best[r][2]);
      if (k >= 3) acc = __fadd_rn(acc, best[r][3]);
      a.out[i] = __fdiv_rn(acc, 3.f);
    } else {
      const float q2 = a.q2[i];
      float* o = a.out + static_cast<size_t>(i) * K;
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = __fadd_rn(best[r][k], q2);
    }
  }
}

using SweepKernel = void (*)(SweepArgs);

// The instance of N1 (kk 0) or of N2 keeping kk values, for R rows a
// thread; nullptr where none is built (R other than the instance's)
SweepKernel gram_instance(int kk, int rows_per_thread) {
  if (kk == 0) {
    if (rows_per_thread != kRowsChamfer) return nullptr;
    return sweep_kernel<1, kRowsChamfer, kChamfer>;
  }
  if (rows_per_thread != kRowsTopK) return nullptr;
  switch (kk) {
    case 1: return sweep_kernel<1, kRowsTopK, kTopK>;
    case 2: return sweep_kernel<2, kRowsTopK, kTopK>;
    case 3: return sweep_kernel<3, kRowsTopK, kTopK>;
    case 4: return sweep_kernel<4, kRowsTopK, kTopK>;
    case 5: return sweep_kernel<5, kRowsTopK, kTopK>;
    case 6: return sweep_kernel<6, kRowsTopK, kTopK>;
    case 7: return sweep_kernel<7, kRowsTopK, kTopK>;
    case kMaxK: return sweep_kernel<kMaxK, kRowsTopK, kTopK>;
    default: return nullptr;
  }
}

// The instance of N3 for R rows a thread; nullptr where none is built
SweepKernel direct_instance(int rows_per_thread) {
  return rows_per_thread == kRowsDirect ? sweep_kernel<kDirectK, kRowsDirect, kDirect3>
                                        : nullptr;
}

// A cluster launch of `kernel` (N1-N3): `row_blocks` clusters of `cluster`
// blocks, each cluster R * kThreads query rows. A refused launch returns
// its error; nothing runs in its place.
int launch_sweep(const SweepArgs& a, SweepKernel kernel, int rows_per_thread, int row_blocks,
                 int cluster, void* stream) {
  const long long rows = static_cast<long long>(kThreads) * rows_per_thread;
  if (kernel == nullptr || cluster < 1 || cluster > kMaxCluster || a.slice < 0 ||
      a.slice % kGroup != 0 || row_blocks < 1 || row_blocks * rows < a.nq ||
      (row_blocks - 1) * rows >= a.nq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_blocks * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches N1 on `stream`: out[i] for the na rows of a against the point set
// `packed` (cluster slices of `slice` rows, ops/knn_kernel.py `pack_points`),
// with the launch plan's rows a thread (8), row blocks and cluster size
// (1..8); returns the cudaError_t of the launch (0 = ok). The caller has
// checked shapes, types, contiguity and the device, and that na > 0.
int lidargs_knn_chamfer(const float* a, const float* a2, const uint8_t* a_valid,
                        const float* packed, float* out, int na, int slice,
                        int rows_per_thread, int row_blocks, int cluster, void* stream) {
  const SweepArgs g{a, a2, a_valid, reinterpret_cast<const float4*>(packed), out, na, slice};
  return launch_sweep(g, gram_instance(0, rows_per_thread), rows_per_thread, row_blocks,
                      cluster, stream);
}

// Launches N2 on `stream`: out [nq, kk], the kk (1..8, at most the set's
// points) smallest squared distances of each query row, ascending, against
// the packed point set, with the launch plan as for N1 (rows a thread 4,
// cluster size 1..8). The caller has
// checked shapes, types, contiguity, the device and kk, and that nq > 0.
int lidargs_knn_gram_topk(const float* q, const float* q2, const float* packed, float* out,
                          int nq, int slice, int kk, int rows_per_thread, int row_blocks,
                          int cluster, void* stream) {
  const SweepArgs g{q, q2, nullptr, reinterpret_cast<const float4*>(packed), out, nq, slice};
  return kk >= 1 ? launch_sweep(g, gram_instance(kk, rows_per_thread), rows_per_thread,
                                row_blocks, cluster, stream)
                 : static_cast<int>(cudaErrorInvalidValue);
}

// *blocks = the blocks of N1 (kk 0) or of N2 keeping kk values, R rows a
// thread, that one SM holds at once (registers and shared memory), for the
// launch plan; returns the cudaError_t of the query.
int lidargs_knn_blocks_per_sm(int kk, int rows_per_thread, int* blocks) {
  const SweepKernel kernel = gram_instance(kk, rows_per_thread);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, 0));
}

// Launches N3 on `stream`: out [n], each point's mean squared distance to
// its 3 nearest others, against the same set packed as (p, 0) rows
// (cluster slices of `slice` rows, the rows past the set +inf), with the
// launch plan's rows a thread (4), row blocks and cluster size (1..8). The
// caller has checked shape, type, contiguity and the device, and that n > 0.
int lidargs_knn3_direct(const float* p, const float* packed, float* out, int n, int slice,
                        int rows_per_thread, int row_blocks, int cluster, void* stream) {
  const SweepArgs g{p, nullptr, nullptr, reinterpret_cast<const float4*>(packed), out, n, slice};
  return launch_sweep(g, direct_instance(rows_per_thread), rows_per_thread, row_blocks, cluster,
                      stream);
}

// *blocks = the blocks of N3, R rows a thread, that one SM holds at once,
// for the launch plan; returns the cudaError_t of the query.
int lidargs_knn3_blocks_per_sm(int rows_per_thread, int* blocks) {
  const SweepKernel kernel = direct_instance(rows_per_thread);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, 0));
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
