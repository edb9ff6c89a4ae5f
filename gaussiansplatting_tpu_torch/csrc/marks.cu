// Stage marks: one empty kernel per stage boundary of a frame, a training
// step and a density event, for the device trace.
//
// Replaces no TPU kernel.  The step and the frame run as CUDA graphs
// (train/graph.py): on a replay the host runs nothing stage by stage, so no
// host span, NVTX range or record_function can split a replay.  A kernel
// launched inside the captured body is a node of the graph, so every replay
// shows gs_mark_<stage> on the profiler's device trace, on the trace's own
// clock; a stage runs from its mark to the next mark on the stream.
// Python side and the list of stages: gaussiansplatting_tpu_torch/utils/
// tracing.py (``STAGES``, ``mark``), which launches through the plain C
// launcher gs_mark_<stage>_launch(stream) on PyTorch's current stream.
//
// What bounds it: nothing but the launch; one thread that does nothing, about
// a microsecond of the graph's chain a mark.  No mark name may hold
// "blend_fwd_win" or "blend_bwd_win": the benchmark's blend rooflines match
// those substrings.

#include <cuda_runtime.h>

#define GS_MARK(stage)                                                   \
  extern "C" __global__ void gs_mark_##stage() {}                        \
  extern "C" int gs_mark_##stage##_launch(void* stream) {                \
    gs_mark_##stage<<<1, 1, 0, (cudaStream_t)stream>>>();                \
    return (int)cudaGetLastError();                                      \
  }

GS_MARK(projection)
GS_MARK(pairs)
GS_MARK(blend)
GS_MARK(compose)
GS_MARK(loss)
GS_MARK(loss_bwd)
GS_MARK(compose_bwd)
GS_MARK(blend_bwd)
GS_MARK(reduction)
GS_MARK(projection_bwd)
GS_MARK(adam)
GS_MARK(sh)
GS_MARK(sh_bwd)
GS_MARK(regularizer)
GS_MARK(regularizer_bwd)
GS_MARK(densify)
GS_MARK(opacity_reset)
GS_MARK(end)
