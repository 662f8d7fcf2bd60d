// Device stage marks: one empty one-thread kernel a stage, launched on the
// caller's stream where a stage of the frame starts
// (radish_pt_tpu_torch/utils/timing.py, mark).  A CUDA graph capture
// records the launch, so every replay runs the mark in stream order among
// the stage's kernels, and a profiler trace splits a replayed frame's
// device time by stage: a stage runs from its mark to the next one.
//
// The kernels do nothing.  Their names (stage_mark_<stage>, C linkage so
// the trace shows them as they are written here) are what a trace reader
// matches; the order below is utils/timing.py's STAGES, then its
// INNER_MARKS, which bracket work inside a stage (the sorted sweeps'
// wavefront reordering, the denoiser after a frame) and start no stage.

#include <cuda_runtime.h>

#define STAGE_MARKS(X) \
  X(gbuffer)           \
  X(primary)           \
  X(ris)               \
  X(shadow)            \
  X(temporal)          \
  X(spatial)           \
  X(shade)             \
  X(accumulate)        \
  X(nee)               \
  X(bsdf)              \
  X(extend)            \
  X(hit)               \
  X(end)               \
  X(reorder)           \
  X(reorder_end)       \
  X(denoise)           \
  X(svgf_levels)       \
  X(denoise_end)

#define DEFINE_MARK(name) \
  extern "C" __global__ void stage_mark_##name() {}
STAGE_MARKS(DEFINE_MARK)
#undef DEFINE_MARK

extern "C" {

// Launches the mark of index ``stage`` (STAGES + INNER_MARKS) on ``stream``;
// returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown index.
int stage_mark(int stage, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int k = 0;
#define LAUNCH_MARK(name)                  \
  if (stage == k++) {                      \
    stage_mark_##name<<<1, 1, 0, s>>>();   \
    return (int)cudaGetLastError();        \
  }
  STAGE_MARKS(LAUNCH_MARK)
#undef LAUNCH_MARK
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
