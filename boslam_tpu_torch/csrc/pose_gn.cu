// Motion-only bundle adjustment in ONE launch: the tracker's robust
// Gauss-Newton on one SE3 pose per block, every round and step inside the
// kernel.
//
// Replaces no Pallas kernel.  It stands for the reference's jax.lax.scan
// Gauss-Newton loops (boslam_tpu/solvers/pose_opt.py:115 over the steps,
// :132 over the rounds), which XLA compiles into one program; eager PyTorch
// ran them as ~4,000 small launches a call.  Plain twin:
// optimize_pose_plain in boslam_tpu_torch/solvers/pose_opt.py, whose
// arithmetic this follows step for step in float32; only the order of the
// sums over edges differs.
//
// Bound on the H100: latency, not bytes or operations.  A call reads ~31 B
// an edge once and does ~250 flops an edge a step: at N = 1024 that is
// 32 KB and ~5 MFLOP, nanoseconds at the card's peaks.  What is left is a
// chain of ba_rounds x ba_iters dependent 6x6 solves, each waiting on a
// reduction over all N edges, plus two cost passes a round.
//
// Design: one 256-thread block per pose of the flattened batch (B = 1 for
// a tracking pass, R candidates for relocalization, the request batch for
// loop verification), so the whole solve stays on one SM.
//  * Each thread owns edges tid, tid + 256, ... (at most EPT = ceil(N /
//    256), templated) and loads them once into registers: world point,
//    observation, depth, flags, octave weight, inlier flag.  Inputs that a
//    caller broadcasts over the batch are read through a batch stride of 0.
//  * A step: each thread sums its edges' 21 upper-triangle entries of H, 6
//    of b and the robust cost; an xor butterfly per warp, then warp 0 adds
//    the 8 warps in order (a fixed order: the same result every run); one
//    thread builds the damped system, factors it (Cholesky), solves,
//    keeps the running lowest-cost iterate (torch.argmin's rule: the first
//    NaN, else the first minimum) and writes exp(xi) o pose to shared
//    memory; one barrier hands it to the block.
//  * A failed factor or a non-finite step gives a zero step, as the plain
//    version's NaN path does.  No early exit: every round runs every step.

#include <cstdint>
#include <cuda_runtime.h>

// Mirrors _PoseGnArgs in ops/pose_cuda.py.  Batch strides are in elements;
// 0 reads one row for every pose.
struct PoseGnArgs {
  const float* pose0;        // [B, 7] (qw, qx, qy, qz, tx, ty, tz) T_cw
  const float* pts;          // [B, N, 3]
  const float* uv;           // [B, N, 2]
  const float* depth;        // [B, N]
  const uint8_t* has_depth;  // [B, N] bool
  const uint8_t* obs_mask;   // [B, N] bool
  const int* octave;         // [B, N] int32, or null: octave 0
  const uint8_t* inliers0;   // [B, N] bool, or null: obs_mask
  float* pose;               // [B, 7]
  uint8_t* inliers;          // [B, N] bool
  int* n_inliers;            // [B]
  float* chi2;               // [B] final robust cost
  long long s_pose0, s_pts, s_uv, s_depth, s_has_depth, s_obs_mask,
      s_octave, s_inliers0;
  int b, n, rounds, iters;
  float fx, fy, cx, cy, depth_weight, huber_delta, chi2_2d, chi2_3d,
      scale_factor;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EPT = 16;        // edges a thread keeps: N <= 4096
constexpr int NH = 21;             // upper triangle of the 6x6 H, row-major
constexpr int NSYS = NH + 6 + 1;   // H, b, cost

struct Edge {
  float X, Y, Z, u, v, d, info;
  bool hd, obs, inl;
};

struct Frame {  // a pose as each thread applies it: x' = R x + t
  float R[9], t[3];
};

__device__ __forceinline__ Frame frame_of(const float* p) {
  // quat_to_mat: equal to quat_rotate's v + 2 (qw u + q x u), u = q x v.
  const float w = p[0], x = p[1], y = p[2], z = p[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  Frame f;
  f.R[0] = 1.f - 2.f * (yy + zz); f.R[1] = 2.f * (xy - wz); f.R[2] = 2.f * (xz + wy);
  f.R[3] = 2.f * (xy + wz); f.R[4] = 1.f - 2.f * (xx + zz); f.R[5] = 2.f * (yz - wx);
  f.R[6] = 2.f * (xz - wy); f.R[7] = 2.f * (yz + wx); f.R[8] = 1.f - 2.f * (xx + yy);
  f.t[0] = p[4]; f.t[1] = p[5]; f.t[2] = p[6];
  return f;
}

// Residual [du, dv, w_d dz] of one edge at a pose (pose_residuals); zero for
// a point behind the camera.  Returns the camera-frame point in xc.
__device__ __forceinline__ void residual(const PoseGnArgs& a, const Edge& e,
                                         const Frame& f, float xc[3],
                                         float r[3], bool& behind) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xc[i] = f.R[3 * i] * e.X + f.R[3 * i + 1] * e.Y + f.R[3 * i + 2] * e.Z +
            f.t[i];
  }
  const float zs = fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2];
  r[0] = a.fx * xc[0] / zs + a.cx - e.u;
  r[1] = a.fy * xc[1] / zs + a.cy - e.v;
  r[2] = e.hd ? a.depth_weight * (xc[2] - e.d) : 0.f;
  behind = xc[2] <= 1e-3f;
  if (behind) r[0] = r[1] = r[2] = 0.f;
}

__device__ __forceinline__ float edge_chi2(const PoseGnArgs& a, const Edge& e,
                                           const Frame& f) {
  float xc[3], r[3];
  bool behind;
  residual(a, e, f, xc, r, behind);
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * e.info;
}

// robust.huber_cost / huber_weight at chi2 (a NaN stays NaN, as torch.clamp
// keeps it).
__device__ __forceinline__ float huber_cost(float chi2, float delta) {
  const float e = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  return e <= delta ? 0.5f * chi2 : delta * (e - 0.5f * delta);
}

__device__ __forceinline__ float huber_weight(float chi2, float delta) {
  const float e = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
  return e <= delta ? 1.f : delta / e;
}

// Sum v[0..K) over the block: an xor butterfly per warp, each warp's sums to
// red[warp][k], and lanes k < K of warp 0 add the warps in order into
// out[k].  Holds one barrier; out is ready for warp 0 after __syncwarp().
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < K) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * K + lane];
      out[lane] = s;
    }
    __syncwarp();
  }
}

// The damped step of one GN iteration: (H + 1e-5 (1 + tr H / 6) I) xi = b by
// Cholesky; zero where the factor fails or the step is not finite.
__device__ __forceinline__ void solve_step(const float* sys, float xi[6]) {
  float A[6][6], L[6][6], y[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = A[j][i] = sys[k++];
    }
  }
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) tr += A[i][i];
  const float damp = 1e-5f * (1.f + tr / 6.f);
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] += damp;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int m = 0; m < j; ++m) s -= L[j][m] * L[j][m];
    ok = ok && s > 0.f;  // LAPACK's test: a pivot <= 0 or NaN fails
    L[j][j] = sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) t -= L[i][m] * L[j][m];
      L[i][j] = t / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = sys[NH + i];
#pragma unroll
    for (int m = 0; m < i; ++m) s -= L[i][m] * y[m];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s -= L[m][i] * xi[m];
    xi[i] = s / L[i][i];
  }
  bool finite = ok;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(xi[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = 0.f;
  }
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = n < 1e-12f ? 1e-12f : n;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] /= n;
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// p <- exp(xi) o p (se3.retract: so3_exp_quat, the left Jacobian V,
// pose_compose), in place.
__device__ __forceinline__ void retract(const float xi[6], float p[7]) {
  const float* om = xi;
  const float* v = xi + 3;
  const float th2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  const bool small = th2 < 1e-12f;
  const float th2s = small ? 1.f : th2;
  const float th = sqrtf(th2s);
  const float kq = small ? 0.5f - th2 / 48.f : sinf(0.5f * th) / th;
  float qd[4] = {small ? 1.f - th2 / 8.f : cosf(0.5f * th), kq * om[0],
                 kq * om[1], kq * om[2]};
  quat_normalize(qd);
  const float a = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2s;
  const float b = small ? 1.f / 6.f - th2 / 120.f
                        : (th - sinf(th)) / (th2s * th);
  // V = I + a W + b W^2, W = hat(omega); td = V v.
  const float W[9] = {0.f, -om[2], om[1], om[2], 0.f, -om[0],
                      -om[1], om[0], 0.f};
  float td[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) w2 += W[3 * i + m] * W[3 * m + j];
      const float vij = (i == j ? 1.f : 0.f) + a * W[3 * i + j] + b * w2;
      s += vij * v[j];
    }
    td[i] = s;
  }
  // pose_compose(exp(xi), p): q = qd * qp, t = rotate(qd, tp) + td.
  const float aw = qd[0], ax = qd[1], ay = qd[2], az = qd[3];
  const float bw = p[0], bx = p[1], by = p[2], bz = p[3];
  float q[4] = {aw * bw - ax * bx - ay * by - az * bz,
                aw * bx + ax * bw + ay * bz - az * by,
                aw * by - ax * bz + ay * bw + az * bx,
                aw * bz + ax * by - ay * bx + az * bw};
  quat_normalize(q);
  float u[3], uu[3];
  cross(qd + 1, p + 4, u);
  cross(qd + 1, u, uu);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[4 + i] = p[4 + i] + 2.f * (aw * u[i] + uu[i]) + td[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = q[i];
}

template <int EPT>
__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(const __grid_constant__ PoseGnArgs a) {
  __shared__ float red[WARPS * NSYS];
  __shared__ float tot[NSYS];
  __shared__ float s_pose[7];
  const int bi = blockIdx.x, tid = threadIdx.x;
  const float delta = a.huber_delta;

  Edge E[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * THREADS;
    Edge& g = E[j];
    if (e < a.n) {
      const float* X = a.pts + bi * a.s_pts + 3LL * e;
      const float* o = a.uv + bi * a.s_uv + 2LL * e;
      g.X = X[0]; g.Y = X[1]; g.Z = X[2];
      g.u = o[0]; g.v = o[1];
      g.d = a.depth[bi * a.s_depth + e];
      g.hd = a.has_depth[bi * a.s_has_depth + e] != 0;
      g.obs = a.obs_mask[bi * a.s_obs_mask + e] != 0;
      g.inl = a.inliers0 ? a.inliers0[bi * a.s_inliers0 + e] != 0 : g.obs;
      const int oct = a.octave ? a.octave[bi * a.s_octave + e] : 0;
      g.info = powf(a.scale_factor, -2.f * static_cast<float>(oct));
    } else {
      g.X = g.Y = g.Z = g.u = g.v = g.d = g.info = 0.f;
      g.hd = g.obs = g.inl = false;
    }
  }
  if (tid < 7) s_pose[tid] = a.pose0[bi * a.s_pose0 + tid];
  __syncthreads();

  // Thread 0's state across a round: the proposal p and the lowest-cost
  // iterate seen (argmin over the round's costs).
  float p[7], best[7], best_cost = 0.f;
  bool best_nan = false;

  for (int round = 0; round < a.rounds; ++round) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 7; ++i) p[i] = s_pose[i];
    }
    for (int it = 0; it < a.iters; ++it) {
      const Frame f = frame_of(s_pose);
      float acc[NSYS];
#pragma unroll
      for (int k = 0; k < NSYS; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const Edge& g = E[j];
        float xc[3], r[3];
        bool behind;
        residual(a, g, f, xc, r, behind);
        const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * g.info;
        const float inl = g.inl ? 1.f : 0.f;
        acc[NSYS - 1] += huber_cost(chi2, delta) * inl;
        const float w = huber_weight(chi2, delta) * g.info * inl;
        // J = [d(u,v)/dxc; w_d e_z] [-hat(xc) | I], zero behind the camera.
        float J[3][6];
        const float x = xc[0], y = xc[1], z = xc[2];
        const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
        const float iz = 1.f / zs, iz2 = iz * iz;
        const float pu = a.fx * iz, qu = -a.fx * x * iz2;
        const float pv = a.fy * iz, qv = -a.fy * y * iz2;
        J[0][0] = qu * y; J[0][1] = pu * z - qu * x; J[0][2] = -pu * y;
        J[0][3] = pu; J[0][4] = 0.f; J[0][5] = qu;
        J[1][0] = -pv * z + qv * y; J[1][1] = -qv * x; J[1][2] = pv * x;
        J[1][3] = 0.f; J[1][4] = pv; J[1][5] = qv;
        const float wd = g.hd ? a.depth_weight : 0.f;
        J[2][0] = wd * y; J[2][1] = -wd * x; J[2][2] = 0.f;
        J[2][3] = 0.f; J[2][4] = 0.f; J[2][5] = wd;
        if (behind) {
#pragma unroll
          for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
            for (int i = 0; i < 6; ++i) J[rr][i] = 0.f;
          }
        }
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float w0 = w * J[0][i], w1 = w * J[1][i], w2 = w * J[2][i];
#pragma unroll
          for (int m = i; m < 6; ++m) {
            acc[k++] += w0 * J[0][m] + w1 * J[1][m] + w2 * J[2][m];
          }
          acc[NH + i] -= w0 * r[0] + w1 * r[1] + w2 * r[2];
        }
      }
      block_sum<NSYS>(acc, red, tot);
      if (tid == 0) {
        const float cost = tot[NSYS - 1];
        const bool nan = isnan(cost);
        if (it == 0 || (!best_nan && (nan || cost < best_cost))) {
          best_cost = cost;
          best_nan = nan;
#pragma unroll
          for (int i = 0; i < 7; ++i) best[i] = p[i];
        }
        float xi[6];
        solve_step(tot, xi);
        retract(xi, p);
#pragma unroll
        for (int i = 0; i < 7; ++i) s_pose[i] = p[i];
      }
      __syncthreads();
    }

    // The final proposal wins if its cost is no worse than the best iterate.
    {
      const Frame f = frame_of(s_pose);
      float c[1] = {0.f};
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        c[0] += huber_cost(edge_chi2(a, E[j], f), delta) *
                (E[j].inl ? 1.f : 0.f);
      }
      block_sum<1>(c, red, tot);
      if (tid == 0 && !(tot[0] <= best_cost)) {
#pragma unroll
        for (int i = 0; i < 7; ++i) s_pose[i] = best[i];
      }
      __syncthreads();
    }

    // Re-gate: inliers are the observed edges under their chi2 bound.
    {
      const Frame f = frame_of(s_pose);
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        Edge& g = E[j];
        const float bound = g.hd ? a.chi2_3d : a.chi2_2d;
        g.inl = g.obs && edge_chi2(a, g, f) < bound;
      }
    }
    // The next round's first read of s_pose is behind block_sum's barrier;
    // thread 0 writes it only after that barrier.
  }

  // The last cost and the inlier count at the final pose.
  const Frame f = frame_of(s_pose);
  float c[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const Edge& g = E[j];
    const float inl = g.inl ? 1.f : 0.f;
    c[0] += huber_cost(edge_chi2(a, g, f), delta) * inl;
    c[1] += inl;
    const int e = tid + j * THREADS;
    if (e < a.n) a.inliers[static_cast<long long>(bi) * a.n + e] = g.inl;
  }
  block_sum<2>(c, red, tot);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) a.pose[bi * 7 + i] = s_pose[i];
    a.chi2[bi] = tot[0];
    a.n_inliers[bi] = static_cast<int>(tot[1]);
  }
}

template <int EPT>
cudaError_t launch(const PoseGnArgs& a, cudaStream_t stream) {
  pose_gn_kernel<EPT><<<a.b, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int boslam_pose_gn(const PoseGnArgs* args, void* stream) {
  const PoseGnArgs& a = *args;
  if (a.b < 1 || a.n < 0 || a.n > THREADS * MAX_EPT || a.rounds < 0 ||
      a.iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ept = (a.n + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ept <= 1) {
    err = launch<1>(a, s);
  } else if (ept <= 2) {
    err = launch<2>(a, s);
  } else if (ept <= 4) {
    err = launch<4>(a, s);
  } else if (ept <= 8) {
    err = launch<8>(a, s);
  } else {
    err = launch<MAX_EPT>(a, s);
  }
  return static_cast<int>(err);
}
