// Stage marks: one empty kernel a stage of the train sub-step and of a
// render chunk, named nerf_mark_<stage>, launched on the caller's stream by
// utils/spans.py:mark.  A mark does no work and touches no memory; in a
// profiler's trace it is a kernel record that names its stage by itself
// (the trace keeps a kernel's name, not its arguments), at its place in
// stream order, and under a CUDA graph capture it becomes a node of the
// graph, so it runs at every replay.  The stage order here is the one of
// spans.py's STAGES, which checks it against nerf_marks_names at load.
#include <cuda_runtime.h>

#define NERF_MARKS(X) \
  X(load) X(pose) X(sample) X(coarse_mlp) X(coarse_composite) X(pdf) \
  X(fine_mlp) X(fine_composite) X(loss) X(backward) X(pose_backward) \
  X(optimizer) X(row) X(upload) X(end) X(cast)

#define NERF_KERNEL(s) extern "C" __global__ void nerf_mark_##s() {}
NERF_MARKS(NERF_KERNEL)

#define NERF_ENTRY(s) nerf_mark_##s,
static void (*const kMarks[])() = {NERF_MARKS(NERF_ENTRY)};

#define NERF_NAME(s) #s ","
static const char kNames[] = NERF_MARKS(NERF_NAME);

static const int kCount = sizeof(kMarks) / sizeof(kMarks[0]);

// The stage names in index order, each followed by a comma.
extern "C" const char* nerf_marks_names() { return kNames; }

// Loads every mark kernel into the current context (a first launch under a
// stream capture would otherwise load its module there); returns the CUDA
// error, 0 on success.
extern "C" int nerf_marks_init() {
  for (int i = 0; i < kCount; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kMarks[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches stage `stage`'s mark on `stream`; returns the launch's CUDA
// error, or -1 for a stage out of range.
extern "C" int nerf_mark(int stage, cudaStream_t stream) {
  if (stage < 0 || stage >= kCount) return -1;
  return (int)cudaLaunchKernel((const void*)kMarks[stage], dim3(1), dim3(1),
                               nullptr, 0, stream);
}
