// K square 32x32 patches of one blurred pyramid level, top-left corner at
// (clip(y, 15, h - 17) - 15, clip(x, 15, w - 17) - 15).
//
// Replaces: boslam_tpu/ops/frontend_pallas.py:extract_patches_pallas (Pallas
// body _patch_kernel).  Plain twin: extract_patches_plain in
// boslam_tpu_torch/ops/frontend_cuda.py.
//
// Bound on the H100: memory.  The function reads K x 4 KB of the level and
// writes K x 4 KB of patches (512 keypoints over a frame: ~4 MB, about
// 1.3 us at 3.35 TB/s).  There is no arithmetic to speak of.
//
// Design: one 256-thread block per keypoint.  The block clips its own
// coordinates (the Pallas kernel's scalar prefetch has no counterpart to
// need), and each thread copies 4 consecutive floats of one patch row, so a
// warp reads 4 rows of 128 contiguous bytes and writes 512 contiguous bytes
// of the output.  The source rows are not 16-byte aligned in general, so
// reads are scalar and writes are float4.  The copy is exact.

#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 32;
constexpr int HALF = 15;
constexpr int THREADS = PATCH * PATCH / 4;

__global__ void __launch_bounds__(THREADS)
extract_patches_kernel(const float* __restrict__ img, const int* __restrict__ ys,
                       const int* __restrict__ xs, float* __restrict__ out,
                       int h, int w) {
  const int k = blockIdx.x;
  const int y = min(max(ys[k], HALF), h - HALF - 2) - HALF;
  const int x = min(max(xs[k], HALF), w - HALF - 2) - HALF;
  const int r = threadIdx.x >> 3;
  const int c = (threadIdx.x & 7) * 4;
  const float* src = img + static_cast<size_t>(y + r) * w + x + c;
  const float4 v = make_float4(src[0], src[1], src[2], src[3]);
  reinterpret_cast<float4*>(out + static_cast<size_t>(k) * PATCH * PATCH +
                            r * PATCH + c)[0] = v;
}

}  // namespace

extern "C" int boslam_extract_patches(const float* img, const int* ys,
                                      const int* xs, float* out, int k, int h,
                                      int w, void* stream) {
  if (k > 0) {
    extract_patches_kernel<<<k, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        img, ys, xs, out, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
