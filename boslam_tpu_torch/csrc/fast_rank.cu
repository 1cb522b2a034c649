// FAST-9 corner score at two thresholds + 3x3 NMS + border mask + rank
// fusion for one pyramid level, on one CUDA block per 32x8 output tile.
//
// Replaces: boslam_tpu/ops/frontend_pallas.py:fast_rank_pallas (Pallas body
// _fast_kernel, helper _contig9).  Plain twin: fast_rank_plain in
// boslam_tpu_torch/ops/frontend_cuda.py.
//
// Bound on the H100: memory.  Per pixel the function must read 4 bytes and
// write 8 (rank + raw): about 0.95 M px x 12 B = 11 MB for the 8 levels of a
// 640x480 frame, a few microseconds at 3.35 TB/s; the 16-tap stencil is ~200
// flops per pixel, far below the FP32 rate.  At these sizes each launch is
// short enough that launch overhead dominates.
//
// Design: the block stages its 40x16 input window (tile + 4 px halo, zeros
// outside the image exactly like jnp.pad(level, 4)) into shared memory with
// coalesced loads, so every input pixel is read from device memory once per
// tile.  The hi/lo scores of the tile plus a 1 px NMS ring (34x10) go to
// shared memory; each thread then runs NMS, border mask and rank fusion for
// its own pixel and writes rank/raw once.  The arithmetic repeats the
// reference's order exactly (16 circle offsets in order k = 0..15,
// d = nb - c, strict '>' bit tests, max(d - t, 0) margins, contiguity on
// uint32), so the maps are bit-identical to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;               // output tile width (one warp)
constexpr int TY = 8;                // output tile height
constexpr int PAD = 4;               // circle radius 3 + 1 px NMS ring
constexpr int SW = TX + 2 * PAD;     // staged input window: 40 x 16
constexpr int SH = TY + 2 * PAD;
constexpr int CW = TX + 2;           // score window incl. NMS ring: 34 x 10
constexpr int CH = TY + 2;

// FAST radius-3 Bresenham circle, clockwise from 12 o'clock (frontend._CIRCLE).
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// >= 9 circularly contiguous bits among bits 0..15.
__device__ __forceinline__ bool contig9(uint32_t m) {
  const uint32_t dup = m | (m << 16);
  uint32_t acc = dup;
#pragma unroll
  for (int s = 1; s < 9; ++s) acc &= dup >> s;
  return (acc & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(TX * TY)
fast_rank_kernel(const float* __restrict__ img, float* __restrict__ rank,
                 float* __restrict__ raw, int h, int w, float t_hi,
                 float t_lo, float boost_hi, int border) {
  __shared__ float tile[SH][SW];
  __shared__ float s_hi[CH][CW];
  __shared__ float s_lo[CH][CW];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int r = i / SW, c = i % SW;
    const int y = y0 - PAD + r, x = x0 - PAD + c;
    tile[r][c] = (y >= 0 && y < h && x >= 0 && x < w)
                     ? img[static_cast<size_t>(y) * w + x] : 0.0f;
  }
  __syncthreads();

  // Score window position (cy, cx) is image pixel (y0 - 1 + cy, x0 - 1 + cx)
  // and staged pixel (cy + 3, cx + 3).
  for (int i = tid; i < CH * CW; i += TX * TY) {
    const int cy = i / CW, cx = i % CW;
    const float c = tile[cy + 3][cx + 3];
    float mb_hi = 0.0f, md_hi = 0.0f, mb_lo = 0.0f, md_lo = 0.0f;
    uint32_t kb_hi = 0u, kd_hi = 0u, kb_lo = 0u, kd_lo = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float d = tile[cy + 3 + kDY[k]][cx + 3 + kDX[k]] - c;
      const float nd = -d;
      const uint32_t bit = 1u << k;
      mb_hi += fmaxf(d - t_hi, 0.0f);
      md_hi += fmaxf(nd - t_hi, 0.0f);
      mb_lo += fmaxf(d - t_lo, 0.0f);
      md_lo += fmaxf(nd - t_lo, 0.0f);
      kb_hi |= (d > t_hi) ? bit : 0u;
      kd_hi |= (nd > t_hi) ? bit : 0u;
      kb_lo |= (d > t_lo) ? bit : 0u;
      kd_lo |= (nd > t_lo) ? bit : 0u;
    }
    s_hi[cy][cx] = fmaxf(contig9(kb_hi) ? mb_hi : 0.0f,
                         contig9(kd_hi) ? md_hi : 0.0f);
    s_lo[cy][cx] = fmaxf(contig9(kb_lo) ? mb_lo : 0.0f,
                         contig9(kd_lo) ? md_lo : 0.0f);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cy = threadIdx.y + 1, cx = threadIdx.x + 1;
  const float in_hi = s_hi[cy][cx];
  const float in_lo = s_lo[cy][cx];
  float mx_hi = in_hi, mx_lo = in_lo;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      mx_hi = fmaxf(mx_hi, s_hi[cy + dy][cx + dx]);
      mx_lo = fmaxf(mx_lo, s_lo[cy + dy][cx + dx]);
    }
  }
  const float nms_hi = (in_hi >= mx_hi && in_hi > 0.0f) ? in_hi : 0.0f;
  const float nms_lo = (in_lo >= mx_lo && in_lo > 0.0f) ? in_lo : 0.0f;
  const bool inb = y >= border && y < h - border && x >= border && x < w - border;
  const float rk = nms_hi > 0.0f ? nms_hi + boost_hi : nms_lo;
  const size_t o = static_cast<size_t>(y) * w + x;
  rank[o] = inb ? rk : 0.0f;
  raw[o] = in_hi > 0.0f ? in_hi : in_lo;
}

}  // namespace

extern "C" int boslam_fast_rank(const float* img, float* rank, float* raw,
                                int h, int w, float t_hi, float t_lo,
                                float boost_hi, int border, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY);
  fast_rank_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, rank, raw, h, w, t_hi, t_lo, boost_hi, border);
  return static_cast<int>(cudaGetLastError());
}
