// Stage stamps on the device's own clock (utils/profiling.py `Telemetry`).
//
// Replaces no TPU kernel: the JAX package times its stages from outside
// (prefix programs and the profiler). This kernel is the port's in-program
// recorder: one thread that reads %globaltimer (nanoseconds) and appends
// entries (step id, id, value) to a device ring, so that a stamp captured
// inside the step's or the render's CUDA graph records where the device is
// in every replay without a synchronize and without the profiler.
//
//   ctl  int64 [4]        [0] on (0: return at once), [1] entries written
//                         (the ring index is that modulo cap), [2] the step
//                         id, [3] 1 while a profiler runs (copied into the
//                         begin stamp's tag)
//   ring int64 [cap, 3]   (step id, id, value) per entry
//
// A stamp appends (step, stage, ns). With `begin` it first advances the
// step id and also appends (step, tag_id, ctl[3]). Up to three device
// scalars v0..v2 (int64; null where absent) follow as (step, first_id + i,
// *v_i), and `rows` (a shape known at capture, < 0 where absent) as (step,
// rows_id, rows).
//
// What bounds it: nothing of the card's throughput; a launch inside a graph
// costs ~1-2 us of the stream, and when off the thread reads one word and
// returns. One thread a launch keeps the entries of a step in the order the
// stream runs them: stamps of one stream never overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(long long* ctl, long long* ring, int cap, int stage, int begin,
                             int tag_id, const long long* v0, const long long* v1,
                             const long long* v2, int first_id, long long rows, int rows_id) {
  if (ctl[0] == 0) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  long long step = ctl[2];
  if (begin) {
    step += 1;
    ctl[2] = step;
  }
  long long n = ctl[1];
  auto put = [&](long long id, long long value) {
    long long* e = ring + 3 * (n % cap);
    e[0] = step;
    e[1] = id;
    e[2] = value;
    ++n;
  };
  put(stage, (long long)ns);
  if (begin) put(tag_id, ctl[3]);
  if (v0) put(first_id, *v0);
  if (v1) put(first_id + 1, *v1);
  if (v2) put(first_id + 2, *v2);
  if (rows >= 0) put(rows_id, rows);
  ctl[1] = n;
}

}  // namespace

extern "C" {

// Launches one stamp on `stream`; returns the cudaError_t of the launch.
// The caller has checked that ctl and ring are int64 on the stream's device
// and that each v_i is null or an int64 scalar there.
int lidargs_stamp(long long* ctl, long long* ring, const long long* v0, const long long* v1,
                  const long long* v2, int cap, int stage, int begin, int tag_id,
                  int first_id, long long rows, int rows_id, void* stream) {
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ctl, ring, cap, stage, begin, tag_id, v0, v1, v2, first_id, rows, rows_id);
  return (int)cudaGetLastError();
}

const char* lidargs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
