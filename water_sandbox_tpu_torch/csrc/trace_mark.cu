// Phase markers of the captured step: one empty kernel a phase of the
// kernel pipeline's rebuild step, named after it, which runtime/
// profiling.py::phase launches at the head of that phase while
// ops/cuda/graph.py::StepGraph captures the step for the runs made while a
// profiler records. Not a port of a Pallas kernel: the kernel's name in a
// device trace is the whole message, so the step's phases show inside a
// graph replay, where every kernel otherwise carries only its own name.
//
// wst_phase_mark launches the marker of `phase` (an index into build,
// density, rescue, force, integrate), 1 block of 1 thread, on `stream` of
// `device`, and returns cudaGetLastError().

#include <cuda_runtime.h>

extern "C" __global__ void wst_phase_build() {}
extern "C" __global__ void wst_phase_density() {}
extern "C" __global__ void wst_phase_rescue() {}
extern "C" __global__ void wst_phase_force() {}
extern "C" __global__ void wst_phase_integrate() {}

extern "C" int wst_phase_mark(int phase, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: wst_phase_build<<<1, 1, 0, s>>>(); break;
    case 1: wst_phase_density<<<1, 1, 0, s>>>(); break;
    case 2: wst_phase_rescue<<<1, 1, 0, s>>>(); break;
    case 3: wst_phase_force<<<1, 1, 0, s>>>(); break;
    case 4: wst_phase_integrate<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
