// The floor under a launch-bound kernel: an empty kernel, one block of one
// warp that does nothing. Its device time is the least one launch takes on
// the card; launched through the kernels' ctypes path (raw stream, a C
// function bound once, the status checked), its time a call is what that
// path costs on the host. Beside it, the same launch behind K8's argument
// list (three pointers, two ints and the stream), the same arguments
// without a launch, and the launch with its arguments packed in one array,
// which split a call's host time into ctypes and the launch.
// chip_smoke.py prints them beside K7 and K8; no path of the port runs them.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int probe_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int probe_empty_launch6(const void*, const void*, void*, int, int, void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int probe_no_launch6(const void*, const void*, void*, int, int, void*) { return 0; }

// args: the six arguments of probe_empty_launch6 as 64-bit integers.
extern "C" int probe_empty_launch_packed(const long long* args) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)args[5]>>>();
  return (int)cudaGetLastError();
}
