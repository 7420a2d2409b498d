// The stage clock: one thread stamps the device's %globaltimer (ns) into a
// ring of step rows, so that a step captured in a CUDA graph records where
// its stages begin and end on every replay, with no host involvement.
//
// Replaces no TPU kernel.  It is the recorder's device half
// (multi_purpose_mpc_tpu_torch/utils/spans.py, StageRing): a graph replay
// keeps no host range, and the profiler ties every kernel of a replay to one
// cudaGraphLaunch, so the split of a replayed step has to be recorded on the
// device, inside the graph.  The plain version is the CPU path of
// StageRing, which stamps time.perf_counter_ns() into the same layout.
//
// ring: (rows, cols) int64; count: the ring's device row counter, the steps
// recorded so far.  A mark writes ring[count % rows, col]; the step's last
// mark (advance = 1) also adds one to count, so that each replay of a graph
// writes the next row.  Stream order puts a mark after the kernels launched
// before it and before the kernels launched after it.
//
// What bounds it: the launch (~1-2 us of a graph node); one 8-byte load and
// one or two 8-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_clock_mark_kernel(int64_t* ring, int64_t* count,
                                        int rows, int cols, int col,
                                        int advance) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int64_t c = *count;
  ring[(c % rows) * cols + col] = (int64_t)now;
  if (advance) *count = c + 1;
}

}  // namespace

extern "C" int stage_clock_mark(int64_t* ring, int64_t* count, int rows,
                                int cols, int col, int advance, void* stream) {
  if (rows <= 0 || cols <= 0 || col < 0 || col >= cols)
    return (int)cudaErrorInvalidValue;
  stage_clock_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      ring, count, rows, cols, col, advance);
  return (int)cudaGetLastError();
}
