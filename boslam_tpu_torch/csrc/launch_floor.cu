// An empty kernel, built and launched like the port's kernels.  Its time on
// the card is the least any one launch costs there: the yardstick for
// kernels whose roofline bound is below it (chip_smoke.py, launch_floor_ms).

#include <cuda_runtime.h>

namespace {
__global__ void launch_floor_kernel() {}
}  // namespace

extern "C" int boslam_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
