// Streaming projection-window Hamming matcher.  Per frame row: the best and
// second-best admissible Hamming distance to the map, the best's column, and
// the match decision (max_dist, ratio, mutual); per map column: the argmin
// over valid frame rows, for the mutual check.  A pair (row, col) is
// admissible when the column is visible and dx*dx + dy*dy <= r2[row] on the
// projected pixels, with r2 = min(r*r, 1e9).
//
// Replaces: boslam_tpu/ops/hamming_pallas.py:fused_match_top2 (Pallas body
// _kernel, launched by _fused_match_pallas) with its epilogue.  Plain twin:
// fused_match_top2_plain in boslam_tpu_torch/ops/hamming_cuda.py.
//
// What bounds it on the H100.  At the engine's shapes (512 frame rows, a
// map of 32768-65536 slots of which a few hundred to a few thousand are
// valid) latency: a handful of live tiles, two launches, each block a few
// dependent loads deep.  On a dense map (every column visible) the pair
// epilogue on the integer units bounds it: per pair 6 operations without a
// window (row key, top-2 update, column key and minimum), 14 with one,
// against 1/128 of an mma.  The distance product itself (2*N*V*256
// operations at 1,979 TOP/s int8, V visible columns) and the bytes
// (descriptors, pixels and masks in once) are far below that.
//
// Design.
//   Distances on the tensor cores, exact in int32:
//   d = |a| + |b| - 2 popc(a AND b), the AND-popcount from
//   mma.sync m16n8k256 .b1 .and.popc, which takes the packed 256-bit
//   descriptors as they lie (one instruction: 16 rows x 8 columns, one whole
//   descriptor each); |a| and |b| once per row and column, not per pair.
//   Pass 1 (match_kernel): one block per (128-column tile, 128-row chunk),
//   4 warps of 2 m16 row tiles each, chunks varying fastest.  A block first
//   reads its tile's visibility; a tile with no visible column records
//   itself dead and does no distance work (the engine's free list fills the
//   lowest slots, so most of its map's tiles are dead).  A live block stages
//   its columns in shared memory (words in the B-fragment order, |b|,
//   pixels) and walks the 16 n8 tiles with each warp's A fragments in
//   registers.  Each pair becomes a row key (d << 8 | column in the tile), a
//   masked pair's raised by 1024 << 8 so that it loses to every admissible
//   one; the row's top-2 is its two smallest keys (k2 = min(k2, max(k1,
//   key)), k1 = min(k1, key)): the best is the lowest column on equal
//   distance and the second the least distance over the other columns, a
//   duplicate of the best's included.  The column key is (d << 20 | row),
//   a masked pair's raised by 2**30 and an invalid row's by 2**31, so the
//   smallest is jnp.argmin's lowest valid row.  In the loop each key leaves
//   out what is constant along its fold (|a| for the row key, |b| for the
//   column key) and is one multiply-add from the mma's count.  Rows fold
//   across the 4 lanes of a quad, columns across the 8 quads (a transposing
//   butterfly) and the 4 warps (shared memory).  The block writes its rows'
//   (k1, k2) to the tile's slot and its columns' keys to the chunk's slot.
//   Without a window (every row's r2 >= 8e8 and every pixel within 1e4 of
//   the origin, so d2 <= 8e8 is certain) a block skips the window test; the
//   test uses __fmul_rn/__fadd_rn, so that no FMA moves a boundary.
//   Pass 2 (merge_kernel): a block of 32 warps per 32 rows lists the live
//   tiles (ballot and one shared atomic per warp), and each warp folds a
//   share of them for the 32 rows, a lane per row and eight loads in flight,
//   with the top-2 merge on 64-bit keys (distance, global column): the order
//   of the fold does not matter, and the lower column wins a tie, which is
//   the reference's rule that the earlier tile wins.  Dead tiles' slots are
//   never read.  The warps' states meet in a tree in shared memory, and
//   warp 0 applies the epilogue: best <= max_dist and best <=
//   ratio * second in float32, as the reference's; for the mutual check the
//   least of the best column's chunk keys names its row.  It writes (idx,
//   ok, dist).
// The last tile may be ragged: its missing columns count as invisible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TC = 128;                   // map columns per pass-1 block
constexpr int RC = 32 * WARPS;            // frame rows per pass-1 block
constexpr int NT = TC / 8;                // n8 column tiles per block
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned BIAS = 256;            // keeps |b| - 2ab and |a| - 2ab >= 0
constexpr unsigned MASKED = 1024u << 8;   // added to a masked pair's row key
constexpr unsigned COL_MASKED = 1u << 30; // ... and to its column key
constexpr unsigned INVALID_ROW = 1u << 31;     // ... to an invalid row's
constexpr unsigned ROW_OUT = 0xE0200000u;      // a row past n: above all
constexpr unsigned ROW_MASK = (1u << 20) - 1;  // rows per call < 2**20
constexpr unsigned MAX_D = 256;           // an admissible distance is <= 256
constexpr float BIG = 1e9f;               // the reference's _BIG
constexpr int BIG_INT = 1000000000;
constexpr float FAR_R2 = 8e8f;            // r2 above every d2 of near pixels
constexpr float NEAR_UV = 1e4f;
static_assert(THREADS == TC, "one staged column per thread");

// 16x8 AND-popcount products of 256-bit rows: a = rows (g, g+8) words
// (t, t+4); b = column g words (t, t+4); d = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) for lane 4g + t.
__device__ __forceinline__ void mma_and_popc(unsigned (&d)[4],
                                             const uint32_t (&a)[4], uint2 b) {
  const unsigned zero = 0;
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(zero));
}

// One lane's four frame rows, [rt][h]: row 32 * warp + 16 * rt + 8 * h + g
// of the chunk.
// The row key of a pair leaves out the row's |a| (the same for all its
// columns) and the column key the column's |b|: each is one multiply-add.
struct Rows {
  uint32_t a[2][4];     // A fragments of the two row tiles
  unsigned na8[2][2];   // (|a| - BIAS) << 8: row key -> d << 8 | column
  unsigned ra[2][2];    // column key base (|a| + BIAS) << 20 | row
  unsigned madd[2][2];  // COL_MASKED, 0 for a row past n
  float u[2][2], v[2][2], r2[2][2];
};

template <bool WINDOW>
__device__ __forceinline__ void match_tile(
    const Rows& R, const uint2* s_b, const unsigned* s_nbk, const float* s_u,
    const float* s_v, int g, int t, unsigned (&k1)[2][2],
    unsigned (&k2)[2][2], unsigned (&ck)[2 * NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint2 b = s_b[4 * (8 * j + g) + t];
    const int c = 8 * j + 2 * t;
    const unsigned nbk[2] = {s_nbk[c], s_nbk[c + 1]};
    float u[2] = {0.0f, 0.0f}, v[2] = {0.0f, 0.0f};
    if (WINDOW) {
      u[0] = s_u[c];
      u[1] = s_u[c + 1];
      v[0] = s_v[c];
      v[1] = s_v[c + 1];
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      unsigned d[4];
      mma_and_popc(d, R.a[rt], b);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q >> 1, e = q & 1;
        unsigned key = nbk[e] - (d[q] << 9);
        unsigned col = R.ra[rt][h] - (d[q] << 21);
        if (WINDOW) {
          const float dx = R.u[rt][h] - u[e];
          const float dy = R.v[rt][h] - v[e];
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if (!(d2 <= R.r2[rt][h])) {
            key += MASKED;
            col += R.madd[rt][h];
          }
        }
        k2[rt][h] = min(k2[rt][h], max(k1[rt][h], key));
        k1[rt][h] = min(k1[rt][h], key);
        ck[2 * j + e] = min(ck[2 * j + e], col);
      }
    }
  }
}

// One butterfly step of the column fold: the lanes with `bit` set keep the
// upper half of their live values, the others the lower, each taking the
// partner's minimum for the half it keeps.
template <int HALF>
__device__ __forceinline__ void fold_half(unsigned (&x)[2 * NT], int lane,
                                          int bit) {
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const unsigned send = up ? x[i] : x[i + HALF];
    const unsigned keep = up ? x[i + HALF] : x[i];
    x[i] = min(keep, __shfl_xor_sync(FULL, send, bit));
  }
}

__global__ void __launch_bounds__(THREADS)
match_kernel(const uint32_t* __restrict__ desc_a,
             const float2* __restrict__ uv_a, const float* __restrict__ r_a,
             const uint8_t* __restrict__ valid_a, int n,
             const uint32_t* __restrict__ desc_b,
             const float2* __restrict__ uv_b,
             const uint8_t* __restrict__ vis_b, int m, int* __restrict__ live,
             uint2* __restrict__ rowpart, unsigned* __restrict__ colpart) {
  __shared__ uint2 s_b[TC * 4];  // column c: (w0 w4) (w1 w5) (w2 w6) (w3 w7)
  __shared__ unsigned s_nbk[TC];  // (|b| + BIAS) << 8 | c, + MASKED if unseen
  __shared__ float s_u[TC];
  __shared__ float s_v[TC];
  __shared__ unsigned s_ck[WARPS][TC];

  // Chunks vary fastest, so that a live tile's blocks start in the first
  // wave, beside the dead tiles' blocks that only look and leave.
  const int chunks = (n + RC - 1) / RC;
  const int tile = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int c0 = tile * TC, r0 = chunk * RC;
  const int c = threadIdx.x;
  const bool in = c0 + c < m;
  const bool vis = in && vis_b[c0 + c] != 0;
  const int any = __syncthreads_or(vis);
  if (chunk == 0 && c == 0) live[tile] = any;
  if (!any) return;

  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  float2 p = make_float2(0.0f, 0.0f);
  if (in) {
    lo = reinterpret_cast<const uint4*>(desc_b)[2 * (c0 + c)];
    hi = reinterpret_cast<const uint4*>(desc_b)[2 * (c0 + c) + 1];
    p = uv_b[c0 + c];
  }
  s_b[4 * c] = make_uint2(lo.x, hi.x);
  s_b[4 * c + 1] = make_uint2(lo.y, hi.y);
  s_b[4 * c + 2] = make_uint2(lo.z, hi.z);
  s_b[4 * c + 3] = make_uint2(lo.w, hi.w);
  const unsigned nb = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) +
                      __popc(lo.w) + __popc(hi.x) + __popc(hi.y) +
                      __popc(hi.z) + __popc(hi.w);
  s_nbk[c] = (((nb + BIAS) << 8) | c) + (vis ? 0u : MASKED);
  s_u[c] = p.x;
  s_v[c] = p.y;
  const bool col_near =
      !vis || (fabsf(p.x) <= NEAR_UV && fabsf(p.y) <= NEAR_UV);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Rows R;
  bool far = true;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 32 * warp + 16 * rt + 8 * h + g;
      uint32_t w0 = 0, w4 = 0;
      R.u[rt][h] = R.v[rt][h] = 0.0f;
      R.r2[rt][h] = BIG;
      R.madd[rt][h] = 0;
      if (row < n) {
        w0 = desc_a[8 * row + t];
        w4 = desc_a[8 * row + t + 4];
        const float2 q = uv_a[row];
        const float r = r_a[row];
        const float x = __fmul_rn(r, r);
        R.u[rt][h] = q.x;
        R.v[rt][h] = q.y;
        R.r2[rt][h] = x > BIG ? BIG : x;  // a NaN stays NaN, as clamp_max
        R.madd[rt][h] = COL_MASKED;
        far = far && R.r2[rt][h] >= FAR_R2 && fabsf(q.x) <= NEAR_UV &&
              fabsf(q.y) <= NEAR_UV;
      }
      R.a[rt][h] = w0;
      R.a[rt][2 + h] = w4;
      unsigned na = __popc(w0) + __popc(w4);
      na += __shfl_xor_sync(FULL, na, 1);
      na += __shfl_xor_sync(FULL, na, 2);
      R.na8[rt][h] = (na - BIAS) << 8;
      R.ra[rt][h] = row >= n ? ROW_OUT
                             : (((na + BIAS) << 20) | row) +
                                   (valid_a[row] ? 0u : INVALID_ROW);
    }
  }
  const bool window = !__syncthreads_and(col_near && far);

  unsigned k1[2][2], k2[2][2], ck[2 * NT];
#pragma unroll
  for (int i = 0; i < 4; ++i) k1[i >> 1][i & 1] = k2[i >> 1][i & 1] = FULL;
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) ck[i] = FULL;
  if (window) {
    match_tile<true>(R, s_b, s_nbk, s_u, s_v, g, t, k1, k2, ck);
  } else {
    match_tile<false>(R, s_b, s_nbk, s_u, s_v, g, t, k1, k2, ck);
  }

  // Rows: the top-2 of the quad's four lanes.
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned a1 = k1[rt][h], a2 = k2[rt][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const unsigned o1 = __shfl_xor_sync(FULL, a1, off);
        const unsigned o2 = __shfl_xor_sync(FULL, a2, off);
        a2 = min(max(a1, o1), min(a2, o2));
        a1 = min(a1, o1);
      }
      const int row = r0 + 32 * warp + 16 * rt + 8 * h + g;
      if (t == 0 && row < n) {
        rowpart[static_cast<size_t>(tile) * n + row] =
            make_uint2(a1 + R.na8[rt][h], a2 + R.na8[rt][h]);
      }
    }
  }

  // Columns: lane 4g + t ends with values 4g .. 4g + 3 (n8 tiles 2g, 2g + 1),
  // then the warps' minima meet in shared memory.
  fold_half<NT>(ck, lane, 16);
  fold_half<NT / 2>(ck, lane, 8);
  fold_half<NT / 4>(ck, lane, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s_ck[warp][8 * (2 * g + (i >> 1)) + 2 * t + (i & 1)] = ck[i];
  }
  __syncthreads();
  if (in) {
    unsigned key = s_ck[0][c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) key = min(key, s_ck[w][c]);
    colpart[static_cast<size_t>(chunk) * m + c0 + c] = key;
  }
}

// A tile's row key as a map-wide 64-bit key: (distance, column).
__device__ __forceinline__ unsigned long long wide(unsigned k, int tile) {
  return (static_cast<unsigned long long>(k >> 8) << 32) |
         (static_cast<unsigned long long>(tile) * TC + (k & 0xFF));
}

__device__ __forceinline__ void merge_top2(unsigned long long& k1,
                                           unsigned long long& k2,
                                           unsigned long long o1,
                                           unsigned long long o2) {
  k2 = min(max(k1, o1), min(k2, o2));
  k1 = min(k1, o1);
}

constexpr int MERGE_WARPS = 32;
constexpr int BATCH = 8;    // partials a lane loads before it folds them
constexpr int LIST = 2048;  // live tiles listed per round

__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const int* __restrict__ live, const uint2* __restrict__ rowpart,
             const unsigned* __restrict__ colpart, int tiles, int chunks,
             const uint8_t* __restrict__ valid_a, int n, int m,
             float max_dist, float ratio, int mutual, int* __restrict__ idx,
             uint8_t* __restrict__ ok, int* __restrict__ dist) {
  __shared__ int s_list[LIST];
  __shared__ int s_count;
  __shared__ unsigned long long s_k[MERGE_WARPS][2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 32 + lane;
  unsigned long long k1 = ~0ull, k2 = ~0ull;
  for (int base = 0; base < tiles; base += LIST) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const int end = min(base + LIST, tiles);
    for (int i0 = base + 32 * warp; i0 < end; i0 += blockDim.x) {
      const int i = i0 + lane;
      const unsigned flags = __ballot_sync(FULL, i < end && live[i]);
      int at = 0;
      if (lane == 0 && flags) at = atomicAdd(&s_count, __popc(flags));
      at = __shfl_sync(FULL, at, 0);
      if (flags >> lane & 1) {
        s_list[at + __popc(flags & ((1u << lane) - 1))] = i;
      }
    }
    __syncthreads();
    const int count = s_count;
    if (row < n) {
      for (int i0 = warp; i0 < count; i0 += MERGE_WARPS * BATCH) {
        int tl[BATCH];
        uint2 p[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int i = i0 + b * MERGE_WARPS;
          tl[b] = i < count ? s_list[i] : -1;
          if (tl[b] >= 0) p[b] = rowpart[static_cast<size_t>(tl[b]) * n + row];
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          if (tl[b] >= 0) {
            merge_top2(k1, k2, wide(p[b].x, tl[b]), wide(p[b].y, tl[b]));
          }
        }
      }
    }
    __syncthreads();
  }
  // The warps' states meet in a tree: warp 0 ends with the row's top-2.
  s_k[warp][0][lane] = k1;
  s_k[warp][1][lane] = k2;
  __syncthreads();
#pragma unroll
  for (int half = MERGE_WARPS / 2; half > 0; half >>= 1) {
    if (warp < half) {
      merge_top2(k1, k2, s_k[warp + half][0][lane], s_k[warp + half][1][lane]);
      s_k[warp][0][lane] = k1;
      s_k[warp][1][lane] = k2;
    }
    __syncthreads();
  }
  if (warp != 0 || row >= n) return;
  const unsigned d1 = static_cast<unsigned>(k1 >> 32);
  const unsigned d2 = static_cast<unsigned>(k2 >> 32);
  const bool matched = d1 <= MAX_D;
  const int bidx = matched ? static_cast<int>(k1 & FULL) : -1;
  const float best = matched ? static_cast<float>(d1) : BIG;
  const float second = d2 <= MAX_D ? static_cast<float>(d2) : BIG;
  bool good = matched && valid_a[row] != 0 && best <= max_dist &&
              best <= __fmul_rn(ratio, second);
  if (good && mutual) {
    unsigned key = FULL;
#pragma unroll 4
    for (int y = 0; y < chunks; ++y) {
      key = min(key, colpart[static_cast<size_t>(y) * m + bidx]);
    }
    good = static_cast<int>(key & ROW_MASK) == row;
  }
  idx[row] = good ? bidx : -1;
  ok[row] = good;
  dist[row] = matched ? static_cast<int>(d1) : BIG_INT;
}

}  // namespace

// Scratch: rowpart ceil(m / 128) * n (k1, k2) pairs, colpart
// ceil(n / 128) * m keys, live ceil(m / 128) flags; only live tiles' slots
// are written and read.  n in [1, 2**20), m >= 1; descriptors 16-byte
// aligned, pixels 8-byte aligned (the wrapper checks).
extern "C" int boslam_fused_match(const void* desc_a, const void* uv_a,
                                  const float* r_a, const uint8_t* valid_a,
                                  int n, const void* desc_b, const void* uv_b,
                                  const uint8_t* vis_b, int m, float max_dist,
                                  float ratio, int mutual, void* rowpart,
                                  unsigned* colpart, int* live, int* idx,
                                  uint8_t* ok, int* dist, void* stream) {
  const int tiles = (m + TC - 1) / TC;
  const int chunks = (n + RC - 1) / RC;
  if (static_cast<long long>(tiles) * chunks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  match_kernel<<<tiles * chunks, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const float2*>(uv_a),
      r_a, valid_a, n, static_cast<const uint32_t*>(desc_b),
      static_cast<const float2*>(uv_b), vis_b, m, live,
      static_cast<uint2*>(rowpart), colpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(n + 31) / 32, 32 * MERGE_WARPS, 0, s>>>(
      live, static_cast<const uint2*>(rowpart), colpart, tiles, chunks,
      valid_a, n, m, max_dist, ratio, mutual, idx, ok, dist);
  return static_cast<int>(cudaGetLastError());
}
