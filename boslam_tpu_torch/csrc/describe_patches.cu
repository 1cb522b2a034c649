// Patch gather + intensity-centroid orientation + binned rotated BRIEF for
// every keypoint of a frame, all pyramid levels in ONE launch.
//
// Replaces: boslam_tpu/ops/frontend_pallas.py:extract_patches_pallas (Pallas
// body _patch_kernel), which copies K clipped 32x32 windows of one blurred
// level to device memory, and the plain tensor code that reads them back
// (boslam_tpu/features/frontend.py:orient_and_brief).  Plain twins:
// extract_patches_plain in boslam_tpu_torch/ops/frontend_cuda.py followed by
// orient_and_brief in boslam_tpu_torch/features/frontend.py.
//
// Bound on the H100: bytes, and under them the launch.  Per keypoint the
// function reads a 4 KB window and 8 B of coordinates and writes 36 B
// (angle + 8 words), and the 32 KB pattern table is read from device memory
// once: 2.2 MB for the 512 keypoints of a frame, under a microsecond at
// 3.35 TB/s.  The copy-only
// kernel wrote the 4 KB patch out as well, once per level, for a chain of
// about 15 small tensor operations to read back.
//
// Design: one 256-thread block per keypoint; the block finds its level in a
// table handed over BY VALUE (a __grid_constant__ parameter: no copy, no
// synchronisation, graph-capturable).  It clips its own coordinates, stages
// the window once into 4 KB of shared memory with coalesced 128-byte row
// reads, and everything after reads shared memory:
//  * moments: the weights dx, dy and the disc mask come from the thread's
//    (row, column), no table.  A product weight x pixel is exact in double
//    (5 bits x 24 bits), so the sums are accumulated in double, in a fixed
//    order (4 values per thread, an xor butterfly per warp, the 8 warps in
//    order), and rounded to f32 once: the correctly rounded moment, the same
//    on every run.  A constant patch gives exactly (0, 0) and angle 0.
//  * angle = atan2f(m01, m10); bin = rintf(angle * (float)(32 / 2 pi)) mod
//    32, the product rounded once (__fmul_rn), as torch.round(angle * c).
//  * descriptor: thread p compares the two samples of pair p at the bin's
//    rotated positions (a [32, 512] uint16 table of flat patch indices made
//    by the host from the package's pattern, 32 KB, L2-resident); one
//    __ballot_sync per warp is word p / 32 with lane i in bit i, the
//    LSB-first order of pack_words.
//  * the patch itself goes to device memory only when the caller asks
//    (extract_patches, the one-level call that keeps the gather checkable).

#include <cstdint>
#include <cuda_runtime.h>

constexpr int MAX_LEVELS = 16;

// Mirrors _PatchLevel / _PatchTable in ops/frontend_cuda.py.
struct PatchLevel {
  const float* img;  // blurred level [h, w]
  const int* ys;     // keypoint rows of this level
  const int* xs;
  int h, w;
  int k0;            // index of the level's first keypoint in the frame
  int pad_;
};

struct PatchTable {
  PatchLevel lv[MAX_LEVELS];
  int n;     // levels in use
  int n_kp;  // grid size: keypoints of all levels
};

namespace {

constexpr int PATCH = 32;
constexpr int HALF = 15;
constexpr int THREADS = 256;
constexpr int N_BINS = 32;
constexpr int N_SAMPLES = 512;  // 256 pairs: first points, then second points
constexpr float kBinsPerRad =
    static_cast<float>(N_BINS / (2.0 * 3.14159265358979323846));

__global__ void __launch_bounds__(THREADS)
describe_patches_kernel(const __grid_constant__ PatchTable tab,
                        const uint16_t* __restrict__ brief,
                        float* __restrict__ angle, int* __restrict__ desc,
                        float* __restrict__ patches) {
  __shared__ __align__(16) float p[PATCH * PATCH];
  __shared__ double red[2][THREADS / 32];
  __shared__ int s_bin;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int l = 0;
  while (l + 1 < tab.n && k >= tab.lv[l + 1].k0) ++l;
  const PatchLevel& lv = tab.lv[l];
  const int j = k - lv.k0;
  const int w = lv.w;
  const int y0 = min(max(lv.ys[j], HALF), lv.h - HALF - 2) - HALF;
  const int x0 = min(max(lv.xs[j], HALF), w - HALF - 2) - HALF;

  // Warp `warp` stages rows warp, warp + 8, warp + 16, warp + 24; lane = column.
  const float* src = lv.img + static_cast<size_t>(y0 + warp) * w + x0 + lane;
  const int dx = lane - HALF;
  double m10 = 0.0, m01 = 0.0;
#pragma unroll
  for (int i = 0; i < PATCH / 8; ++i) {
    const int r = warp + 8 * i;
    const float v = src[static_cast<size_t>(8 * i) * w];
    p[r * PATCH + lane] = v;
    const int dy = r - HALF;
    // The 31x31 disc; row and column 31 (dx or dy = 16) fall outside it.
    if (dx * dx + dy * dy <= HALF * HALF) {
      m10 += static_cast<double>(dx) * static_cast<double>(v);
      m01 += static_cast<double>(dy) * static_cast<double>(v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_xor_sync(0xFFFFFFFFu, m10, o);
    m01 += __shfl_xor_sync(0xFFFFFFFFu, m01, o);
  }
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }
  __syncthreads();
  if (tid == 0) {
    double s10 = red[0][0], s01 = red[1][0];
#pragma unroll
    for (int q = 1; q < THREADS / 32; ++q) {
      s10 += red[0][q];
      s01 += red[1][q];
    }
    const float a = atan2f(static_cast<float>(s01), static_cast<float>(s10));
    angle[k] = a;
    s_bin = static_cast<int>(rintf(__fmul_rn(a, kBinsPerRad))) & (N_BINS - 1);
  }
  __syncthreads();

  const uint16_t* pat = brief + s_bin * N_SAMPLES;
  const bool bit = p[pat[tid]] < p[pat[N_SAMPLES / 2 + tid]];
  const unsigned word = __ballot_sync(0xFFFFFFFFu, bit);
  if (lane == 0) desc[k * (N_SAMPLES / 2 / 32) + warp] = static_cast<int>(word);

  if (patches != nullptr) {
    reinterpret_cast<float4*>(patches +
                              static_cast<size_t>(k) * PATCH * PATCH)[tid] =
        reinterpret_cast<const float4*>(p)[tid];
  }
}

}  // namespace

// table: host memory, copied into the launch.  patches: [n_kp, 32, 32] or
// null.  brief: [32, 512] uint16 flat patch indices (< 1024).
extern "C" int boslam_describe_patches(const PatchTable* table,
                                       const uint16_t* brief, float* angle,
                                       int* desc, float* patches,
                                       void* stream) {
  if (table->n < 1 || table->n > MAX_LEVELS || table->n_kp < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  describe_patches_kernel<<<table->n_kp, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      *table, brief, angle, desc, patches);
  return static_cast<int>(cudaGetLastError());
}
