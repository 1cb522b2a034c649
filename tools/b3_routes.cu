// Distance-stage probe of kernel B3's routes on Hopper: 256-bit Hamming
// distances between N frame rows and M map columns, reduced per
// (128-column tile, row) to the smallest key (distance << 8 | column in the
// tile).  One route per build, chosen with -DROUTE=:
//   0  popc:       8 x __popc(a ^ b) per pair on the integer ALUs
//   1  mma_b1:     mma.sync m16n8k256 .b1 .and.popc, packed words as they lie
//   2  wgmma_u8:   wgmma m64n128k32 u8, the tiles' bits unpacked to bytes in
//                  shared memory, 8 k-steps per descriptor
//   3  wgmma_b1:   wgmma m64n128k256 .b1 .and.popc (ptxas of CUDA 12.8 takes it)
// A block covers 128 rows x 128 columns with 128 threads.  N and M are
// multiples of 128.  The mma routes compute |a| + |b| - 2 popc(a & b).
// Built and timed by tools/b3_route_probe.py; not part of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ROUTE
#define ROUTE 1
#endif

namespace {

constexpr int TC = 128;  // columns per block
constexpr int RC = 128;  // rows per block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int popc8(const uint32_t* w) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += __popc(w[i]);
  return s;
}

#if ROUTE == 0
__global__ void __launch_bounds__(RC)
probe_kernel(const uint32_t* __restrict__ da, int n,
             const uint32_t* __restrict__ db, int m, unsigned* part) {
  __shared__ uint4 s_b[2 * TC];
  const int c0 = blockIdx.x * TC;
  for (int c = threadIdx.x; c < TC; c += RC) {
    s_b[2 * c] = reinterpret_cast<const uint4*>(db)[2 * (c0 + c)];
    s_b[2 * c + 1] = reinterpret_cast<const uint4*>(db)[2 * (c0 + c) + 1];
  }
  __syncthreads();
  const int row = blockIdx.y * RC + threadIdx.x;
  const uint4 alo = reinterpret_cast<const uint4*>(da)[2 * row];
  const uint4 ahi = reinterpret_cast<const uint4*>(da)[2 * row + 1];
  unsigned best = FULL;
#pragma unroll 8
  for (int c = 0; c < TC; ++c) {
    const uint4 blo = s_b[2 * c], bhi = s_b[2 * c + 1];
    const unsigned d = __popc(alo.x ^ blo.x) + __popc(alo.y ^ blo.y) +
                       __popc(alo.z ^ blo.z) + __popc(alo.w ^ blo.w) +
                       __popc(ahi.x ^ bhi.x) + __popc(ahi.y ^ bhi.y) +
                       __popc(ahi.z ^ bhi.z) + __popc(ahi.w ^ bhi.w);
    best = min(best, (d << 8) | c);
  }
  part[static_cast<size_t>(blockIdx.x) * n + row] = best;
}
#endif

#if ROUTE == 1
__global__ void __launch_bounds__(RC)
probe_kernel(const uint32_t* __restrict__ da, int n,
             const uint32_t* __restrict__ db, int m, unsigned* part) {
  // Column c's words stored as [w0 w4 w1 w5 w2 w6 w3 w7]: the fragment of
  // lane (g, t) is the 8 bytes at c * 32 + t * 8.
  __shared__ uint2 s_b[TC * 4];
  __shared__ int s_nb[TC];
  const int c0 = blockIdx.x * TC;
  for (int c = threadIdx.x; c < TC; c += RC) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = db[8 * (c0 + c) + i];
#pragma unroll
    for (int t = 0; t < 4; ++t) s_b[4 * c + t] = make_uint2(w[t], w[t + 4]);
    s_nb[c] = popc8(w);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[2][4];
  int na[2][2];
  unsigned best[2][2];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
    const int r = blockIdx.y * RC + warp * 32 + rt * 16 + g;
    a[rt][0] = da[8 * r + t];
    a[rt][1] = da[8 * (r + 8) + t];
    a[rt][2] = da[8 * r + t + 4];
    a[rt][3] = da[8 * (r + 8) + t + 4];
    // |a| from the quad's four lanes, as the shipped kernel has it.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int s = __popc(a[rt][h]) + __popc(a[rt][2 + h]);
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      na[rt][h] = s;
    }
    best[rt][0] = best[rt][1] = FULL;
  }
#pragma unroll 4
  for (int j = 0; j < TC / 8; ++j) {
    const uint2 b = s_b[4 * (8 * j + g) + t];
    const int nb0 = s_nb[8 * j + 2 * t], nb1 = s_nb[8 * j + 2 * t + 1];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      int d0, d1, d2, d3;
      const int zero = 0;
      asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
          : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
          : "r"(a[rt][0]), "r"(a[rt][1]), "r"(a[rt][2]), "r"(a[rt][3]),
            "r"(b.x), "r"(b.y), "r"(zero));
      const unsigned col = 8 * j + 2 * t;
      best[rt][0] = min(best[rt][0],
                        ((unsigned)(na[rt][0] + nb0 - 2 * d0) << 8) | col);
      best[rt][0] = min(best[rt][0],
                        ((unsigned)(na[rt][0] + nb1 - 2 * d1) << 8) | (col + 1));
      best[rt][1] = min(best[rt][1],
                        ((unsigned)(na[rt][1] + nb0 - 2 * d2) << 8) | col);
      best[rt][1] = min(best[rt][1],
                        ((unsigned)(na[rt][1] + nb1 - 2 * d3) << 8) | (col + 1));
    }
  }
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned v = best[rt][h];
      v = min(v, __shfl_xor_sync(FULL, v, 1));
      v = min(v, __shfl_xor_sync(FULL, v, 2));
      if (t == 0) {
        const int r = blockIdx.y * RC + warp * 32 + rt * 16 + g + 8 * h;
        part[static_cast<size_t>(blockIdx.x) * n + r] = v;
      }
    }
  }
}
#endif

#if ROUTE >= 2
// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes; lbo = byte stride between core matrices along K, sbo = along M/N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

#define ACC64(X)                                                           \
  "+r"(X[0]), "+r"(X[1]), "+r"(X[2]), "+r"(X[3]), "+r"(X[4]), "+r"(X[5]),  \
  "+r"(X[6]), "+r"(X[7]), "+r"(X[8]), "+r"(X[9]), "+r"(X[10]),             \
  "+r"(X[11]), "+r"(X[12]), "+r"(X[13]), "+r"(X[14]), "+r"(X[15]),         \
  "+r"(X[16]), "+r"(X[17]), "+r"(X[18]), "+r"(X[19]), "+r"(X[20]),         \
  "+r"(X[21]), "+r"(X[22]), "+r"(X[23]), "+r"(X[24]), "+r"(X[25]),         \
  "+r"(X[26]), "+r"(X[27]), "+r"(X[28]), "+r"(X[29]), "+r"(X[30]),         \
  "+r"(X[31]), "+r"(X[32]), "+r"(X[33]), "+r"(X[34]), "+r"(X[35]),         \
  "+r"(X[36]), "+r"(X[37]), "+r"(X[38]), "+r"(X[39]), "+r"(X[40]),         \
  "+r"(X[41]), "+r"(X[42]), "+r"(X[43]), "+r"(X[44]), "+r"(X[45]),         \
  "+r"(X[46]), "+r"(X[47]), "+r"(X[48]), "+r"(X[49]), "+r"(X[50]),         \
  "+r"(X[51]), "+r"(X[52]), "+r"(X[53]), "+r"(X[54]), "+r"(X[55]),         \
  "+r"(X[56]), "+r"(X[57]), "+r"(X[58]), "+r"(X[59]), "+r"(X[60]),         \
  "+r"(X[61]), "+r"(X[62]), "+r"(X[63])

#define REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#if ROUTE == 2
constexpr int ROW_BYTES = 256;  // one byte per bit
#else
constexpr int ROW_BYTES = 32;   // packed bits
#endif
constexpr int KCM = ROW_BYTES / 16;  // core matrices along K per row group

__device__ __forceinline__ void wgmma_tile(int (&acc)[64], uint64_t da,
                                           uint64_t db, int k) {
#if ROUTE == 2
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 " REGS64
      ", %64, %65, p;\n}\n"
      : ACC64(acc)
      : "l"(da), "l"(db), "r"(k));
#else
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc " REGS64
      ", %64, %65, p;\n}\n"
      : ACC64(acc)
      : "l"(da), "l"(db), "r"(k));
#endif
}

// Store row r's 8 words into a core-matrix tile: byte kb of row r lies at
// ((r / 8) * KCM + kb / 16) * 128 + (r % 8) * 16 + kb % 16.
__device__ __forceinline__ void stage_row(uint8_t* tile, int r,
                                          const uint32_t* w) {
  uint8_t* base = tile + (r >> 3) * KCM * 128 + (r & 7) * 16;
#if ROUTE == 2
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned x = w[i] >> (16 * h);
      uint4 v;
      v.x = ((x & 0xF) * 0x00204081u) & 0x01010101u;
      v.y = (((x >> 4) & 0xF) * 0x00204081u) & 0x01010101u;
      v.z = (((x >> 8) & 0xF) * 0x00204081u) & 0x01010101u;
      v.w = (((x >> 12) & 0xF) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint4*>(base + (2 * i + h) * 128) = v;
    }
  }
#else
  *reinterpret_cast<uint4*>(base) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(base + 128) = make_uint4(w[4], w[5], w[6], w[7]);
#endif
}

__global__ void __launch_bounds__(RC)
probe_kernel(const uint32_t* __restrict__ da, int n,
             const uint32_t* __restrict__ db, int m, unsigned* part) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_a = smem;                       // RC rows
  uint8_t* s_b = smem + RC * ROW_BYTES;      // TC columns
  int* s_na = reinterpret_cast<int*>(s_b + TC * ROW_BYTES);
  int* s_nb = s_na + RC;
  const int c0 = blockIdx.x * TC, r0 = blockIdx.y * RC;
  {
    uint32_t w[8];
    const int i = threadIdx.x;
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = da[8 * (r0 + i) + k];
    stage_row(s_a, i, w);
    s_na[i] = popc8(w);
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = db[8 * (c0 + i) + k];
    stage_row(s_b, i, w);
    s_nb[i] = popc8(w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned lbo = 128, sbo = KCM * 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int mg = 0; mg < RC / 64; ++mg) {
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < ROW_BYTES / 32; ++k) {
      const uint64_t desc_a =
          smem_desc(s_a + mg * 8 * KCM * 128 + 2 * k * 128, lbo, sbo);
      const uint64_t desc_b = smem_desc(s_b + 2 * k * 128, lbo, sbo);
      wgmma_tile(acc, desc_a, desc_b, k);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const int ra = mg * 64 + warp * 16 + g;
    const int na0 = s_na[ra], na1 = s_na[ra + 8];
    unsigned b0 = FULL, b1 = FULL;
#pragma unroll
    for (int j = 0; j < TC / 8; ++j) {
      const unsigned col = 8 * j + 2 * t;
      const int nb0 = s_nb[col], nb1 = s_nb[col + 1];
      b0 = min(b0, ((unsigned)(na0 + nb0 - 2 * acc[4 * j]) << 8) | col);
      b0 = min(b0, ((unsigned)(na0 + nb1 - 2 * acc[4 * j + 1]) << 8) | (col + 1));
      b1 = min(b1, ((unsigned)(na1 + nb0 - 2 * acc[4 * j + 2]) << 8) | col);
      b1 = min(b1, ((unsigned)(na1 + nb1 - 2 * acc[4 * j + 3]) << 8) | (col + 1));
    }
    b0 = min(b0, __shfl_xor_sync(FULL, b0, 1));
    b0 = min(b0, __shfl_xor_sync(FULL, b0, 2));
    b1 = min(b1, __shfl_xor_sync(FULL, b1, 1));
    b1 = min(b1, __shfl_xor_sync(FULL, b1, 2));
    if (t == 0) {
      part[static_cast<size_t>(blockIdx.x) * n + r0 + ra] = b0;
      part[static_cast<size_t>(blockIdx.x) * n + r0 + ra + 8] = b1;
    }
  }
}
#endif

}  // namespace

extern "C" int b3_probe(const void* da, int n, const void* db, int m,
                        unsigned* part, void* stream) {
  if (n % RC || m % TC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m / TC, n / RC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if ROUTE >= 2
  const int smem = (RC + TC) * ROW_BYTES + (RC + TC) * 4;
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(probe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    set = true;
  }
  probe_kernel<<<grid, RC, smem, s>>>(static_cast<const uint32_t*>(da), n,
                                      static_cast<const uint32_t*>(db), m,
                                      part);
#else
  probe_kernel<<<grid, RC, 0, s>>>(static_cast<const uint32_t*>(da), n,
                                   static_cast<const uint32_t*>(db), m, part);
#endif
  return static_cast<int>(cudaGetLastError());
}
