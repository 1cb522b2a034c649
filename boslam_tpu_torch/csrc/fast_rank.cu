// FAST-9 corner score at two thresholds + 3x3 NMS + border mask + rank
// fusion for every level of an image pyramid in ONE launch.
//
// Replaces: boslam_tpu/ops/frontend_pallas.py:fast_rank_pallas (Pallas body
// _fast_kernel, helper _contig9), which the reference calls once per level.
// Plain twin: fast_rank_plain in boslam_tpu_torch/ops/frontend_cuda.py.
//
// Bound on the H100: by the roofline, bytes: the 8 levels of a 640x480
// frame are 0.95 M px at 12 B each (read the level, write rank and raw),
// 11 MB or 3.4 us at 3.35 TB/s; the f32 adds, maxima and compares the data
// needs come to less.  In practice two other things bound it.  A launch per
// level costs more than that on the device and far more on the host, and a
// small level (134x179) cannot fill 132 SMs on its own.  And none of the
// operations is a multiply-add: each takes an instruction slot of its own,
// as do the shared-memory loads and bit operations beside it, and the
// kernel is bound by the SMs' instruction rate.
//
// Design:
//  * One launch for the whole pyramid.  The host hands over a table of
//    levels (pointers, shape, first tile index, tiles per row) BY VALUE as a
//    __grid_constant__ kernel parameter: no host-to-device copy, nothing to
//    synchronise, and a CUDA graph captures it as it is.  The grid is the
//    flat list of all levels' tiles; a block finds its level by scanning at
//    most 16 prefix sums.  Ragged edges are masked per level.
//  * The tile is chosen by its SCORE window, not its outputs: OX x OY
//    outputs need an (OX+2) x (OY+2) window of scores (the NMS ring).  At
//    30x30 outputs that window is 32x32 = 4 scores for each of the 256
//    threads, a warp per window row (no bank conflicts, no tail pass), and
//    the halo recompute is 1024/900 = 1.14x.  The host lays the grid out for
//    the same tile (FAST_TILE in ops/frontend_cuda.py).
//  * The block stages its input window (tile + 4 px, zeros outside the image
//    exactly as jnp.pad(level, 4)) into shared memory with row/column
//    counters advanced incrementally; scores go to shared memory; the same
//    thread then runs NMS, border mask and rank fusion for its positions.
//  * A score done in full takes about 440 instruction slots, and most
//    pixels are no corner (a fifth are, at the lower threshold, on a richly
//    textured synthetic frame).  So pass 1 gives
//    every position only the bit test at the lower threshold (a third of
//    the work; a pixel that fails it scores 0 at both thresholds), and lists
//    the corners in shared memory; pass 2 computes the margins for the
//    listed corners, spread evenly over the block whatever their place in
//    the tile; NMS reads neighbours only around a score.  What comes out is
//    the same to the bit.
//  * The arithmetic repeats the reference's order exactly (16 circle offsets
//    in order k = 0..15, d = nb - c, strict '>' bit tests, max(d - t, 0)
//    margins, contiguity on uint32), with the offsets as immediates, so the
//    maps are bit-identical to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int MAX_LEVELS = 16;

// Mirrors _FastLevel / _FastTable in ops/frontend_cuda.py.
struct FastLevel {
  const float* img;
  float* rank;
  float* raw;
  int h, w;
  int tile0;    // index of the level's first tile in the flat grid
  int tiles_x;  // tiles per row of tiles
};

struct FastTable {
  FastLevel lv[MAX_LEVELS];
  int n;        // levels in use
  int n_tiles;  // grid size
};

namespace {

constexpr int OX = 30;               // output tile (FAST_TILE on the host)
constexpr int OY = 30;
constexpr int NT = 256;              // threads per block
constexpr int PAD = 4;               // circle radius 3 + 1 px NMS ring
constexpr int SW = OX + 2 * PAD;     // staged input window
constexpr int SH = OY + 2 * PAD;
constexpr int CW = OX + 2;           // score window incl. NMS ring
constexpr int CH = OY + 2;
static_assert(OX >= 1 && OY >= 1 && CH * CW <= 65536,
              "score positions are listed as uint16");
static_assert((SH * SW + 2 * CH * CW) * 4 + CH * CW * 2 + 4 <= 48 * 1024,
              "the tile's windows must fit static shared memory");

// >= 9 circularly contiguous bits among bits 0..15.
__device__ __forceinline__ bool contig9(uint32_t m) {
  const uint32_t dup = m | (m << 16);
  uint32_t acc = dup;
#pragma unroll
  for (int s = 1; s < 9; ++s) acc &= dup >> s;
  return (acc & 0xFFFFu) != 0u;
}

// Radius-3 Bresenham circle, clockwise from 12 o'clock (frontend_cuda.CIRCLE):
// TAP(k, dx, dy) for k = 0..15, the offsets as immediates.
#define FAST_CIRCLE(TAP)                                        \
  TAP(0, 0, -3) TAP(1, 1, -3) TAP(2, 2, -2) TAP(3, 3, -1)       \
  TAP(4, 3, 0) TAP(5, 3, 1) TAP(6, 2, 2) TAP(7, 1, 3)           \
  TAP(8, 0, 3) TAP(9, -1, 3) TAP(10, -2, 2) TAP(11, -3, 1)      \
  TAP(12, -3, 0) TAP(13, -3, -1) TAP(14, -2, -2) TAP(15, -1, -3)

// Whether the staged pixel t[0] (row stride SW) is a FAST-9 corner at
// threshold t_min.  The bits at a higher threshold are a subset of these, so
// a pixel that fails here scores 0 at both thresholds.
__device__ __forceinline__ bool fast_candidate(const float* t, float t_min) {
  const float c = t[0];
  uint32_t kb = 0u, kd = 0u;
#define TAP(K, DX, DY)                                  \
  {                                                     \
    const float d = t[(DY) * SW + (DX)] - c;            \
    kb |= (d > t_min) ? (1u << (K)) : 0u;               \
    kd |= (-d > t_min) ? (1u << (K)) : 0u;              \
  }
  FAST_CIRCLE(TAP)
#undef TAP
  return contig9(kb) || contig9(kd);
}

// hi/lo FAST scores of the staged pixel t[0].
__device__ __forceinline__ void fast_scores(const float* t, float t_hi,
                                            float t_lo, float& s_hi,
                                            float& s_lo) {
  const float c = t[0];
  float mb_hi = 0.0f, md_hi = 0.0f, mb_lo = 0.0f, md_lo = 0.0f;
  uint32_t kb_hi = 0u, kd_hi = 0u, kb_lo = 0u, kd_lo = 0u;
#define TAP(K, DX, DY)                                  \
  {                                                     \
    const float d = t[(DY) * SW + (DX)] - c;            \
    const float nd = -d;                                \
    const uint32_t bit = 1u << (K);                     \
    mb_hi += fmaxf(d - t_hi, 0.0f);                     \
    md_hi += fmaxf(nd - t_hi, 0.0f);                    \
    mb_lo += fmaxf(d - t_lo, 0.0f);                     \
    md_lo += fmaxf(nd - t_lo, 0.0f);                    \
    kb_hi |= (d > t_hi) ? bit : 0u;                     \
    kd_hi |= (nd > t_hi) ? bit : 0u;                    \
    kb_lo |= (d > t_lo) ? bit : 0u;                     \
    kd_lo |= (nd > t_lo) ? bit : 0u;                    \
  }
  FAST_CIRCLE(TAP)
#undef TAP
  s_hi = fmaxf(contig9(kb_hi) ? mb_hi : 0.0f, contig9(kd_hi) ? md_hi : 0.0f);
  s_lo = fmaxf(contig9(kb_lo) ? mb_lo : 0.0f, contig9(kd_lo) ? md_lo : 0.0f);
}

__global__ void __launch_bounds__(NT)
fast_rank_kernel(const __grid_constant__ FastTable tab, float t_hi, float t_lo,
                 float boost_hi, int border) {
  __shared__ float tile[SH * SW];
  __shared__ float s_hi[CH * CW];
  __shared__ float s_lo[CH * CW];
  __shared__ uint16_t cand[CH * CW];  // score positions that are corners
  __shared__ int n_cand;

  const int bid = blockIdx.x;
  int l = 0;
  while (l + 1 < tab.n && bid >= tab.lv[l + 1].tile0) ++l;
  const FastLevel& lv = tab.lv[l];
  const int h = lv.h, w = lv.w;
  const int t_idx = bid - lv.tile0;
  const int tile_y = t_idx / lv.tiles_x;
  const int x0 = (t_idx - tile_y * lv.tiles_x) * OX;
  const int y0 = tile_y * OY;
  const int tid = threadIdx.x;
  if (tid == 0) n_cand = 0;

  // Stage the input window; (r, c) follow i without a division per element.
  {
    int r = tid / SW, c = tid - r * SW;
    const float* __restrict__ img = lv.img;
    for (int i = tid; i < SH * SW; i += NT) {
      const int y = y0 - PAD + r, x = x0 - PAD + c;
      tile[i] = (y >= 0 && y < h && x >= 0 && x < w)
                    ? img[static_cast<size_t>(y) * w + x] : 0.0f;
      r += NT / SW;
      c += NT % SW;
      if (c >= SW) { c -= SW; ++r; }
    }
  }
  __syncthreads();

  // Score window position (cy, cx) is image pixel (y0 - 1 + cy, x0 - 1 + cx)
  // and staged pixel (cy + 3, cx + 3).  Pass 1: every position takes the
  // cheap corner test (positions past the ring of a ragged level feed no
  // output and are skipped); the few that pass are listed.
  const float t_min = fminf(t_hi, t_lo);
  const int cy0 = tid / CW, cx0 = tid - cy0 * CW;
  {
    int cy = cy0, cx = cx0;
    for (int i = tid; i < CH * CW; i += NT) {
      s_hi[i] = 0.0f;
      s_lo[i] = 0.0f;
      if (y0 - 1 + cy <= h && x0 - 1 + cx <= w &&
          fast_candidate(&tile[(cy + 3) * SW + cx + 3], t_min)) {
        cand[atomicAdd(&n_cand, 1)] = static_cast<uint16_t>(i);
      }
      cy += NT / CW;
      cx += NT % CW;
      if (cx >= CW) { cx -= CW; ++cy; }
    }
  }
  __syncthreads();

  // Pass 2: the margins, for the listed corners only, spread over the block.
  // Each score depends on its own pixel alone, so the list's order is free.
  for (int j = tid; j < n_cand; j += NT) {
    const int i = cand[j];
    const int cy = i / CW, cx = i - cy * CW;
    fast_scores(&tile[(cy + 3) * SW + cx + 3], t_hi, t_lo, s_hi[i], s_lo[i]);
  }
  __syncthreads();

  // NMS, border mask and rank fusion at the window's interior positions.
  // A position that scores 0 at both thresholds survives no NMS: its
  // neighbours are read only where there is a score.
  int cy = cy0, cx = cx0;
  for (int i = tid; i < CH * CW; i += NT) {
    const int y = y0 - 1 + cy, x = x0 - 1 + cx;
    if (cy >= 1 && cy <= OY && cx >= 1 && cx <= OX && y < h && x < w) {
      const float in_hi = s_hi[i];
      const float in_lo = s_lo[i];
      float rk = 0.0f;
      const bool inb = y >= border && y < h - border && x >= border &&
                       x < w - border;
      if (inb && (in_hi > 0.0f || in_lo > 0.0f)) {
        float mx_hi = in_hi, mx_lo = in_lo;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            mx_hi = fmaxf(mx_hi, s_hi[i + dy * CW + dx]);
            mx_lo = fmaxf(mx_lo, s_lo[i + dy * CW + dx]);
          }
        }
        const float nms_hi = (in_hi >= mx_hi && in_hi > 0.0f) ? in_hi : 0.0f;
        const float nms_lo = (in_lo >= mx_lo && in_lo > 0.0f) ? in_lo : 0.0f;
        rk = nms_hi > 0.0f ? nms_hi + boost_hi : nms_lo;
      }
      const size_t o = static_cast<size_t>(y) * w + x;
      lv.rank[o] = rk;
      lv.raw[o] = in_hi > 0.0f ? in_hi : in_lo;
    }
    cy += NT / CW;
    cx += NT % CW;
    if (cx >= CW) { cx -= CW; ++cy; }
  }
}

}  // namespace

// table: host memory; it is copied into the launch.
extern "C" int boslam_fast_rank(const FastTable* table, float t_hi, float t_lo,
                                float boost_hi, int border, void* stream) {
  if (table->n < 1 || table->n > MAX_LEVELS || table->n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fast_rank_kernel<<<table->n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, t_hi, t_lo, boost_hi, border);
  return static_cast<int>(cudaGetLastError());
}
