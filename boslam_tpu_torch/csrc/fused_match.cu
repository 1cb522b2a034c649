// Streaming projection-window Hamming matcher.  Per frame row: the best and
// second-best admissible Hamming distance to the map and the best's column;
// per map column: the argmin over valid frame rows (the mutual check).  A
// pair (row, col) is admissible when the column is visible and
// dx*dx + dy*dy <= r2[row] on the projected pixels.
//
// Replaces: boslam_tpu/ops/hamming_pallas.py:fused_match_top2 (Pallas body
// _kernel, launched by _fused_match_pallas).  Plain twin:
// fused_match_top2_plain in boslam_tpu_torch/ops/hamming_cuda.py.  The
// epilogue (max_dist, ratio, mutual) stays in PyTorch, as in the reference.
//
// Bound on the H100: operations.  At N = 512 rows against M = 65536 columns
// the distance product as the TPU computes it (bf16 bits, 2*N*M*256) is
// 17.2 GOP, 0.017 ms at 989 TFLOP/s; the bytes (descriptors, pixels, masks
// in; four short vectors out) are ~3 MB, 0.001 ms at 3.35 TB/s.
//
// Design: the TPU walks the map tiles in order and carries the row state in
// VMEM.  Here the tiles run in parallel and a second pass merges them.
//   Pass 1: one block per tile of 128 map columns, which it stages in
//   shared memory (4 KB of descriptors, pixels, visibility); each thread owns
//   one frame row, keeps its 8 words in registers and walks the tile's
//   columns in order, so the row's (min, first argmin, min excluding the
//   argmin) needs no reduction across threads.  The distance is
//   8 x __popc(a ^ b) on the integer units: exact, and equal to the
//   reference's |a| + |b| - 2 a.b.  The window sum uses __fmul_rn/__fadd_rn
//   so that nvcc cannot contract it into an FMA and move a boundary.  For the
//   column argmin each warp reduces a packed key (distance << 20 | row, a
//   masked pair counting as 511 > 256) with one __reduce_min_sync per
//   column, and lane j folds column j into a shared atomicMin: the smallest
//   key is the smallest distance, ties to the lowest row, as jnp.argmin.
//   Each (tile, row) writes its (m1, a1, m2) to a [T, N] partial.
//   Pass 2: one warp per row folds the T partials with the top-2 merge
//   (best = min, second = min(max(b, b'), min(s, s')), index of the best
//   with ties to the lower column, which is the reference's rule that the
//   earlier tile wins), so the fold order does not matter.
// The last tile may be ragged: its block walks only the columns that exist.
// A simple kernel on the integer ALUs: no wgmma, no TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;          // map columns per pass-1 block
constexpr int ROWS = 256;          // frame rows per pass-1 step (threads)
constexpr int BIG = 1000000000;    // the reference's _BIG (exact in float)
constexpr unsigned MASKED_D = 511; // column-key distance of a masked pair
constexpr int ROW_BITS = 20;       // rows per call < 2**20
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(ROWS)
match_tiles_kernel(const uint4* __restrict__ desc_a,
                   const float2* __restrict__ uv_a,
                   const float* __restrict__ r2_a,
                   const uint8_t* __restrict__ valid_a, int n,
                   const uint4* __restrict__ desc_b,
                   const float2* __restrict__ uv_b,
                   const uint8_t* __restrict__ vis_b, int m,
                   int* __restrict__ part_m1, int* __restrict__ part_a1,
                   int* __restrict__ part_m2, int* __restrict__ colarg) {
  __shared__ uint4 s_desc[2 * TILE];
  __shared__ float s_u[TILE];
  __shared__ float s_v[TILE];
  __shared__ int s_vis[TILE];
  __shared__ unsigned s_colkey[TILE];

  const int c0 = blockIdx.x * TILE;
  const int cols = min(TILE, m - c0);
  for (int c = threadIdx.x; c < TILE; c += ROWS) {
    if (c < cols) {
      s_desc[2 * c] = desc_b[2 * (c0 + c)];
      s_desc[2 * c + 1] = desc_b[2 * (c0 + c) + 1];
      const float2 p = uv_b[c0 + c];
      s_u[c] = p.x;
      s_v[c] = p.y;
      s_vis[c] = vis_b[c0 + c] != 0;
    }
    s_colkey[c] = FULL;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int row = r0 + threadIdx.x;
    const bool live = row < n;
    uint4 alo = make_uint4(0, 0, 0, 0), ahi = alo;
    float ua = 0.0f, va = 0.0f, r2 = -1.0f;
    bool row_ok = false;
    if (live) {
      alo = desc_a[2 * row];
      ahi = desc_a[2 * row + 1];
      const float2 p = uv_a[row];
      ua = p.x;
      va = p.y;
      r2 = r2_a[row];
      row_ok = valid_a[row] != 0;
    }
    int m1 = BIG, a1 = 0, m2 = BIG;
    for (int cc = 0; cc < TILE; cc += 32) {
      unsigned acc = FULL;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = cc + j;
        if (c < cols) {  // the same for every thread of the block
          const uint4 blo = s_desc[2 * c];
          const uint4 bhi = s_desc[2 * c + 1];
          const int d = __popc(alo.x ^ blo.x) + __popc(alo.y ^ blo.y) +
                        __popc(alo.z ^ blo.z) + __popc(alo.w ^ blo.w) +
                        __popc(ahi.x ^ bhi.x) + __popc(ahi.y ^ bhi.y) +
                        __popc(ahi.z ^ bhi.z) + __popc(ahi.w ^ bhi.w);
          const float dx = ua - s_u[c];
          const float dy = va - s_v[c];
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const bool adm = (d2 <= r2) && s_vis[c];
          const int dm = adm ? d : BIG;
          if (dm < m1) {
            m2 = m1;
            m1 = dm;
            a1 = c;
          } else if (dm < m2) {
            m2 = dm;
          }
          const unsigned key =
              live ? ((((adm && row_ok) ? static_cast<unsigned>(d) : MASKED_D)
                       << ROW_BITS) | static_cast<unsigned>(row))
                   : FULL;
          const unsigned w = __reduce_min_sync(FULL, key);
          if (lane == j) acc = w;
        }
      }
      if (cc + lane < cols) atomicMin(&s_colkey[cc + lane], acc);
    }
    if (live) {
      const size_t o = static_cast<size_t>(blockIdx.x) * n + row;
      part_m1[o] = m1;
      part_a1[o] = c0 + a1;
      part_m2[o] = m2;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += ROWS) {
    colarg[c0 + c] = static_cast<int>(s_colkey[c] & ((1u << ROW_BITS) - 1));
  }
}

// Top-2 merge of two row states.  A state with b == BIG has i == -1.
__device__ __forceinline__ void merge_top2(int& b, int& s, int& i, int ob,
                                           int os, int oi) {
  const int ni = b < ob ? i : (ob < b ? oi : min(i, oi));
  s = min(max(b, ob), min(s, os));
  b = min(b, ob);
  i = ni;
}

constexpr int MERGE_THREADS = 256;

__global__ void __launch_bounds__(MERGE_THREADS)
merge_tiles_kernel(const int* __restrict__ part_m1,
                   const int* __restrict__ part_a1,
                   const int* __restrict__ part_m2, int n, int tiles,
                   float* __restrict__ best, float* __restrict__ second,
                   int* __restrict__ bidx) {
  const int row = blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps
  int b = BIG, s = BIG, i = -1;
  for (int t = lane; t < tiles; t += 32) {
    const size_t o = static_cast<size_t>(t) * n + row;
    const int tm1 = part_m1[o];
    merge_top2(b, s, i, tm1, part_m2[o], tm1 < BIG ? part_a1[o] : -1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(FULL, b, off);
    const int os = __shfl_down_sync(FULL, s, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    merge_top2(b, s, i, ob, os, oi);
  }
  if (lane == 0) {
    best[row] = static_cast<float>(b);
    second[row] = static_cast<float>(s);
    bidx[row] = i;
  }
}

}  // namespace

// part: 3 * ceil(m / 128) * n int32 of scratch.  n in [1, 2**20), m >= 1;
// descriptors 16-byte aligned, pixels 8-byte aligned (the wrapper checks).
extern "C" int boslam_fused_match(const void* desc_a, const void* uv_a,
                                  const float* r2_a, const uint8_t* valid_a,
                                  int n, const void* desc_b, const void* uv_b,
                                  const uint8_t* vis_b, int m, int* part,
                                  int* colarg, float* best, float* second,
                                  int* bidx, void* stream) {
  const int tiles = (m + TILE - 1) / TILE;
  const size_t plane = static_cast<size_t>(tiles) * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  match_tiles_kernel<<<tiles, ROWS, 0, s>>>(
      static_cast<const uint4*>(desc_a), static_cast<const float2*>(uv_a),
      r2_a, valid_a, n, static_cast<const uint4*>(desc_b),
      static_cast<const float2*>(uv_b), vis_b, m, part, part + plane,
      part + 2 * plane, colarg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = MERGE_THREADS / 32;
  merge_tiles_kernel<<<(n + rows_per_block - 1) / rows_per_block,
                       MERGE_THREADS, 0, s>>>(part, part + plane,
                                              part + 2 * plane, n, tiles,
                                              best, second, bidx);
  return static_cast<int>(cudaGetLastError());
}
