// K3: RANSAC under the RGB-D Mahalanobis noise model.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py mahal_hypothesis_scores
// (479-526), body _mahal_kernel (405-476), and, with it, the rest of
// rgbdslam_tpu/solvers/ransac_se3.py ransac_se3 (264-370) that XLA fused
// around that kernel on the TPU: the compaction of the valid slots, the
// H x S draws, the H Horn fits, the selection of the winner and the masked
// refits. Eager PyTorch fuses nothing, so with the TPU kernel's boundary the
// scorer was one launch among ~2,400 small ones.
//
// For hypothesis [R|t] and correspondence i: d = R p1 + t - p2,
// C = R diag(s1) R^T + diag(s2) (six unique entries),
// m^2 = d^T adj(C) d / det(C) clamped at 0; an inlier has m^2 <= th and a
// valid slot. Per hypothesis: inlier count and the sum of m^2 over inliers.
//
// Two entry points share the device functions below:
//   rgbd_mahal_hypothesis_scores  the scorer alone (the TPU kernel's cut):
//       hypotheses and covariances are inputs; one launch of
//       mahal_scores_kernel writes every count and sum (see its note). The
//       TPU kernel scores a tile of 32 hypotheses against all N planes held
//       in VMEM; here a block scores G = 4 or 8 hypotheses against a chunk
//       of the points held in registers, so a point is read H / G times and
//       not H times, and the chunks of a group (at most 8, one block each)
//       are combined inside the launch by a thread-block cluster, in rank
//       order, through distributed shared memory. At H = 256, N = 1024 the
//       grid is 64 groups of 4 x 8 chunks = 512 blocks of 128 threads, at
//       B = 13 32 groups of 8 x 8 chunks x 13 = 3,328.
//   rgbd_ransac_se3               the whole function, two kernels on one
//       stream:
//     A, ransac_fit_score_kernel, grid (H, B): block (h, b) finds its S
//       sample slots (any S; the slots in dynamic shared memory) by a block
//       scan of b's validity mask (the compaction, done redundantly: 1 KB
//       per block), one thread fits the pose by Horn's method (the weight
//       sum, centroids and cross-covariance in passes over the S slots, in
//       weighted_rigid_transform's order; 30 power iterations in registers),
//       then the block scores the pose against all N correspondences under
//       the error model. It writes T (16), count, sum of errors; nothing
//       (H, N) or (H, S, 3) reaches device memory.
//     B, ransac_select_refine_kernel, grid (B): one block per problem holds
//       the N correspondences as planes in shared memory (31 N bytes,
//       dynamic; past the 227 KB a block may use, N > ~7,400, the same
//       planes in a global scratch buffer, read through L2), takes
//       the arg max of rank = count * 1e4 - min(rmse, 9e3) with the first
//       index on ties, scores the winner, and runs the refits: three block
//       reductions (weight sum, centroids, cross-covariance), one Horn fit,
//       one scoring, keep or drop. With the Mahalanobis polish it then runs
//       its Gauss-Newton rounds (a pass, one block sum of 27 entries, a
//       damped pivoted 6x6 solve and a left exp-compose, se3_solve.cuh, as
//       K4 does) and one scoring, keep or drop. It writes T21, the inlier
//       mask, count, rmse and success.
// Error models (RansacConfig.error_model, a switch in both kernels):
// mahalanobis (m^2 <= th, error m^2), euclidean (|d| <= threshold),
// adaptive_euclidean (threshold + coeff z_mean^2), reprojection (pixel
// distance of the two projections, the camera by value), both (reprojection
// and euclidean); every model but mahalanobis adds |d|^2 to the error.
//
// What bounds it on an H100: 256 x 1024 pairs x ~100 flops is 26 MFLOP in
// f32 from 30 KB of inputs: microseconds of throughput. The time is
// latency: 2 + 4 x refine_iters dependent block reductions and
// 1 + refine_iters serial Horn fits of 30 dependent iterations in kernel B
// (one more fit per block in kernel A, all blocks in parallel), plus two
// launches. The design keeps every dependent step inside one block, on
// shared memory and registers, so a step costs a barrier and not a launch;
// a refit's re-scoring of the pose it starts from repeats the previous
// scoring bit for bit and is not done again.
// The scorer alone has the same throughput and no dependent step: its time
// is one launch, one pass over a block's points and one cluster barrier.
//
// Rounding: the library is built with -fmad=false and each m^2 is computed
// in the Pallas kernel's operation order, so counts equal the plain
// version's exactly for the same pose. Sums run over fixed trees (no float
// atomics): a seed reproduces its run. The fits sum in another order than
// torch's einsum and matmul, so a pose differs from the plain version's in
// its last bits.
//
// Batch: the last grid dimension is the batch entry with its own
// correspondences, validity, draws and hypotheses (the keyframe backend
// verifies all its candidate keyframes in one call). The unbatched call is
// the batch of one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

#include "se3_solve.cuh"

constexpr int kThreads = 256;      // kernel A
constexpr int kScoreThreads = 128; // the scorer alone: a block's points a pass
constexpr int kScoreWarps = kScoreThreads / 32;
constexpr int kMaxChunks = 8;      // the scorer alone: blocks a cluster (the portable most)
constexpr int kSelThreads = 512;   // kernel B
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kPowerIters = 30;
constexpr unsigned kFull = 0xffffffffu;

struct Pose {       // rows of [R | t]
  float r[9];
  float t[3];
};

struct Noise {      // sigma = (cx z, cy z, (dsf z z)^2)
  float cx, cy, dsf;
};

// RANSAC's error models (RansacConfig.error_model), in the order of
// ransac_se3.ERROR_MODELS
enum ErrorModel { kMahalanobis = 0, kEuclidean = 1, kAdaptive = 2, kReprojection = 3, kBoth = 4 };

// What decides an inlier: the model and its parameters, passed by value.
struct Model {
  int kind;
  Noise nz;          // mahalanobis: the per-point covariance from z
  float th;          // mahalanobis: the largest m^2 of an inlier
  float thr_m;       // euclidean, adaptive, both: the distance threshold (m)
  float coeff;       // adaptive: thr_m + coeff z_mean^2
  float reproj_th;   // reprojection, both: the pixel threshold
  float fx, fy, cx, cy;
};

__device__ __forceinline__ void set_identity(Pose& P) {
  for (int k = 0; k < 9; ++k) P.r[k] = (k % 4 == 0) ? 1.0f : 0.0f;
  P.t[0] = P.t[1] = P.t[2] = 0.0f;
}

__device__ __forceinline__ void load_pose(const float* __restrict__ T, Pose& P) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) P.r[3 * i + j] = T[4 * i + j];
    P.t[i] = T[4 * i + 3];
  }
}

__device__ __forceinline__ void store_pose(const Pose& P, float* __restrict__ T) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[4 * i + j] = P.r[3 * i + j];
    T[4 * i + 3] = P.t[i];
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

__device__ __forceinline__ void sigma_diag(const Noise& nz, float z, float& s0,
                                           float& s1, float& s2) {
  s0 = nz.cx * z;
  s1 = nz.cy * z;
  const float sz = nz.dsf * z * z;
  s2 = sz * sz;
}

// m^2 of one correspondence under P; a = diag(s1), b = diag(s2)
__device__ __forceinline__ float mahal_m2(const Pose& P, float x1, float y1, float z1,
                                          float x2, float y2, float z2, float a0,
                                          float a1, float a2, float b0, float b1,
                                          float b2) {
  const float R0 = P.r[0], R1 = P.r[1], R2 = P.r[2];
  const float R3 = P.r[3], R4 = P.r[4], R5 = P.r[5];
  const float R6 = P.r[6], R7 = P.r[7], R8 = P.r[8];
  const float d1 = R0 * x1 + R1 * y1 + R2 * z1 + P.t[0] - x2;
  const float d2 = R3 * x1 + R4 * y1 + R5 * z1 + P.t[1] - y2;
  const float d3 = R6 * x1 + R7 * y1 + R8 * z1 + P.t[2] - z2;

  // C_ij = sum_k R_ik R_jk s1_k (+ s2_i on the diagonal)
  const float a = R0 * R0 * a0 + R1 * R1 * a1 + R2 * R2 * a2 + b0;
  const float b = R0 * R3 * a0 + R1 * R4 * a1 + R2 * R5 * a2;
  const float c = R0 * R6 * a0 + R1 * R7 * a1 + R2 * R8 * a2;
  const float d = R3 * R3 * a0 + R4 * R4 * a1 + R5 * R5 * a2 + b1;
  const float e = R3 * R6 * a0 + R4 * R7 * a1 + R5 * R8 * a2;
  const float f = R6 * R6 * a0 + R7 * R7 * a1 + R8 * R8 * a2 + b2;

  const float A11 = d * f - e * e;
  const float A12 = c * e - b * f;
  const float A13 = b * e - c * d;
  const float A22 = a * f - c * c;
  const float A23 = b * c - a * e;
  const float A33 = a * d - b * b;
  const float det = a * A11 + b * A12 + c * A13;
  const float quad = A11 * d1 * d1 + A22 * d2 * d2 + A33 * d3 * d3
                     + 2.0f * (A12 * d1 * d2 + A13 * d1 * d3 + A23 * d2 * d3);
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  const float m2 = quad * inv_det;
  return (m2 < 0.0f) ? 0.0f : m2;                // max(m2, 0), NaN kept
}

// Whether the correspondence (p1, p2) is an inlier of pose P under the model
// (the caller adds the slot's validity), with its error in `err`: m^2 under
// mahalanobis; else delta^2, delta = |R p1 + t - p2| rounded as a root, as
// _score (rgbdslam_tpu/solvers/ransac_se3.py:146-189) computes it. The
// reprojection clamps both depths at 1e-6 and keeps a NaN.
__device__ __forceinline__ bool pair_inlier(const Model& md, const Pose& P, float x1, float y1,
                                            float z1, float x2, float y2, float z2,
                                            float& err) {
  if (md.kind == kMahalanobis) {
    float a0, a1, a2, b0, b1, b2;
    sigma_diag(md.nz, z1, a0, a1, a2);
    sigma_diag(md.nz, z2, b0, b1, b2);
    err = mahal_m2(P, x1, y1, z1, x2, y2, z2, a0, a1, a2, b0, b1, b2);
    return err <= md.th;
  }
  const float q0 = P.r[0] * x1 + P.r[1] * y1 + P.r[2] * z1 + P.t[0];
  const float q1 = P.r[3] * x1 + P.r[4] * y1 + P.r[5] * z1 + P.t[1];
  const float q2 = P.r[6] * x1 + P.r[7] * y1 + P.r[8] * z1 + P.t[2];
  const float d0 = q0 - x2, d1 = q1 - y2, d2 = q2 - z2;
  const float delta = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  err = delta * delta;
  if (md.kind == kEuclidean) return delta <= md.thr_m;
  if (md.kind == kAdaptive) {
    const float zm = 0.5f * (z1 + z2);
    return delta <= md.thr_m + md.coeff * zm * zm;
  }
  const float zq = q2 < 1e-6f ? 1e-6f : q2;
  const float zt = z2 < 1e-6f ? 1e-6f : z2;
  const float du = (md.fx * q0 / zq + md.cx) - (md.fx * x2 / zt + md.cx);
  const float dv = (md.fy * q1 / zq + md.cy) - (md.fy * y2 / zt + md.cy);
  const bool ok = sqrtf(du * du + dv * dv) <= md.reproj_th;
  return md.kind == kBoth ? ok && delta <= md.thr_m : ok;
}

// Block sums of a 256-thread block's (count, error) partials over a fixed
// shared-memory tree; the result is read from s_cnt[0], s_err[0].
__device__ __forceinline__ void reduce_cnt_err(int cnt, float err, int* s_cnt,
                                               float* s_err) {
  s_cnt[threadIdx.x] = cnt;
  s_err[threadIdx.x] = err;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_cnt[threadIdx.x] += s_cnt[threadIdx.x + stride];
      s_err[threadIdx.x] += s_err[threadIdx.x + stride];
    }
    __syncthreads();
  }
}

// sqrt(err / count), 1e9 under three inliers
__device__ __forceinline__ float rmse_of(int cnt, float err) {
  return (cnt >= 3) ? sqrtf(err / (float)max(cnt, 1)) : 1e9f;
}

// Weighted rigid fit from the normalized moments: S = sum wn q1 q2^T
// (row-major, q = p - c), centroids c1, c2 and the weight sum. Horn's
// quaternion by shifted power iteration; a zero weight sum gives the
// identity. S = 0 (every sample the same slot) gives a NaN pose, as in the
// plain version: its m^2 are NaN and it scores no inlier.
__device__ void horn_pose(const float* S, const float* c1, const float* c2,
                          float wsum, Pose& P) {
  if (wsum <= 1e-12f) {
    set_identity(P);
    return;
  }
  const float Sxx = S[0], Sxy = S[1], Sxz = S[2];
  const float Syx = S[3], Syy = S[4], Syz = S[5];
  const float Szx = S[6], Szy = S[7], Szz = S[8];
  float M[4][4];
  M[0][0] = Sxx + Syy + Szz;
  M[0][1] = Syz - Szy;
  M[0][2] = Szx - Sxz;
  M[0][3] = Sxy - Syx;
  M[1][1] = Sxx - Syy - Szz;
  M[1][2] = Sxy + Syx;
  M[1][3] = Szx + Sxz;
  M[2][2] = -Sxx + Syy - Szz;
  M[2][3] = Syz + Szy;
  M[3][3] = -Sxx - Syy + Szz;
  for (int i = 1; i < 4; ++i)
    for (int j = 0; j < i; ++j) M[i][j] = M[j][i];
  // shift so the largest algebraic eigenvalue is also largest in magnitude
  // (Gershgorin row-sum bound)
  float shift = 0.0f;
  for (int i = 0; i < 4; ++i) {
    const float row = fabsf(M[i][0]) + fabsf(M[i][1]) + fabsf(M[i][2]) + fabsf(M[i][3]);
    shift = (i == 0 || row > shift) ? row : shift;
  }
  for (int i = 0; i < 4; ++i) M[i][i] = M[i][i] + shift;

  float q[4] = {1.0f, 0.03f, 0.02f, 0.01f};
  const float n0 = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n0;
  for (int it = 0; it < kPowerIters; ++it) {
    float v[4];
    for (int i = 0; i < 4; ++i)
      v[i] = M[i][0] * q[0] + M[i][1] * q[1] + M[i][2] * q[2] + M[i][3] * q[3];
    const float nrm = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
    const float den = (nrm < 1e-20f) ? 1e-20f : nrm;
    for (int i = 0; i < 4; ++i) q[i] = v[i] / den;
  }
  // (w, x, y, z) -> rotation, normalized once more as the plain version does
  const float nq = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + q[0] * q[0]);
  const float x = q[1] / nq, y = q[2] / nq, z = q[3] / nq, w = q[0] / nq;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  P.r[0] = 1.0f - 2.0f * (yy + zz);
  P.r[1] = 2.0f * (xy - wz);
  P.r[2] = 2.0f * (xz + wy);
  P.r[3] = 2.0f * (xy + wz);
  P.r[4] = 1.0f - 2.0f * (xx + zz);
  P.r[5] = 2.0f * (yz - wx);
  P.r[6] = 2.0f * (xz - wy);
  P.r[7] = 2.0f * (yz + wx);
  P.r[8] = 1.0f - 2.0f * (xx + yy);
  for (int i = 0; i < 3; ++i)
    P.t[i] = c2[i] - (P.r[3 * i] * c1[0] + P.r[3 * i + 1] * c1[1] + P.r[3 * i + 2] * c1[2]);
}

// ---------------------------------------------------------------------------
// the scorer alone
// ---------------------------------------------------------------------------

// Grid (ceil(H / G), chunks, B), launched as clusters of the `chunks`
// blocks of one (group, batch entry): block (x, r, z) scores hypotheses
// G x .. G x + G - 1 of entry z against the points
// [r span, min(n, (r + 1) span)), span = ceil(n / chunks). Its rank in the
// cluster is r (the cluster spans the whole y dimension).
//   1. The group's poses go to shared memory, once.
//   2. Thread t reads its points r span + t, + kScoreThreads, ... from global
//      memory once each (13 values in registers; a warp's loads are one
//      contiguous run of each array) and scores each against the group's
//      poses, adding count and m^2 of each inlier in point order. The poses
//      are read from shared memory at each use (volatile): held in registers
//      across the point loop, 8 poses and their products took all 255
//      registers and spilled.
//   3. Each warp sums each hypothesis's count by __reduce_add_sync and its
//      m^2 by the xor tree (lanes i and i ^ 16, then ^ 8, ... ^ 1); thread g
//      adds hypothesis g's warp partials in warp order and stores the sums
//      into row r of block 0's table through distributed shared memory.
//   4. After one cluster barrier, block 0 adds the rows in rank order and
//      writes the results; the other blocks are done. No float atomics: two
//      calls give the same bits.
// G (4 or 8, chosen by the wrapper) changes which block scores a
// hypothesis, not the order of its sums: the results do not depend on it.
template <int G>
__global__ void __launch_bounds__(kScoreThreads)
mahal_scores_kernel(const float* __restrict__ T, const float* __restrict__ p1,
                    const float* __restrict__ p2, const float* __restrict__ s1,
                    const float* __restrict__ s2,
                    const unsigned char* __restrict__ valid, int h, int n, int span,
                    float th, int* __restrict__ cnt_out, float* __restrict__ err_out) {
  __shared__ float s_pose[G][12];
  __shared__ int s_wcnt[kScoreWarps][G];
  __shared__ float s_werr[kScoreWarps][G];
  __shared__ int s_cnt[kMaxChunks][G];      // block 0's: every block's sums
  __shared__ float s_err[kMaxChunks][G];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.y, chunks = gridDim.y;
  const size_t z = blockIdx.z;
  const int h0 = blockIdx.x * G;
  const int ng = min(G, h - h0);
  p1 += z * (size_t)n * 3;
  p2 += z * (size_t)n * 3;
  s1 += z * (size_t)n * 3;
  s2 += z * (size_t)n * 3;
  valid += z * (size_t)n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < ng * 12) {
    const int g = tid / 12, k = tid % 12;
    const float* Tg = T + (z * h + h0 + g) * 16;
    s_pose[g][k] = (k < 9) ? Tg[4 * (k / 3) + k % 3] : Tg[4 * (k - 9) + 3];
  }
  __syncthreads();

  int cnt[G];
  float err[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cnt[g] = 0;
    err[g] = 0.0f;
  }
  const int hi = min(n, rank * span + span);
  for (int i = rank * span + tid; i < hi; i += kScoreThreads) {
    const float x1 = p1[3 * i], y1 = p1[3 * i + 1], z1 = p1[3 * i + 2];
    const float x2 = p2[3 * i], y2 = p2[3 * i + 1], z2 = p2[3 * i + 2];
    const float a0 = s1[3 * i], a1 = s1[3 * i + 1], a2 = s1[3 * i + 2];
    const float b0 = s2[3 * i], b1 = s2[3 * i + 1], b2 = s2[3 * i + 2];
    const bool v = valid[i] != 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < ng) {
        const volatile float* sp = s_pose[g];
        Pose P;
#pragma unroll
        for (int k = 0; k < 9; ++k) P.r[k] = sp[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) P.t[k] = sp[9 + k];
        const float m2 = mahal_m2(P, x1, y1, z1, x2, y2, z2, a0, a1, a2, b0, b1, b2);
        if (m2 <= th && v) {
          cnt[g] += 1;
          err[g] += m2;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int c = __reduce_add_sync(kFull, cnt[g]);
    float e = err[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
    if (lane == 0) {
      s_wcnt[warp][g] = c;
      s_werr[warp][g] = e;
    }
  }
  __syncthreads();
  if (tid < G) {
    int c = s_wcnt[0][tid];
    float e = s_werr[0][tid];
#pragma unroll
    for (int w = 1; w < kScoreWarps; ++w) {
      c += s_wcnt[w][tid];
      e += s_werr[w][tid];
    }
    *cluster.map_shared_rank(&s_cnt[rank][tid], 0) = c;
    *cluster.map_shared_rank(&s_err[rank][tid], 0) = e;
  }
  cluster.sync();
  if (rank == 0 && tid < ng) {
    int c = s_cnt[0][tid];
    float e = s_err[0][tid];
    for (int r = 1; r < chunks; ++r) {
      c += s_cnt[r][tid];
      e += s_err[r][tid];
    }
    cnt_out[z * h + h0 + tid] = c;
    err_out[z * h + h0 + tid] = e;
  }
}

// ---------------------------------------------------------------------------
// kernel A: sample, fit and score one hypothesis per block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ransac_fit_score_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                        const float* __restrict__ w,
                        const unsigned char* __restrict__ valid,
                        const float* __restrict__ u, const int* __restrict__ draws,
                        int n, int sample, Model md, float* __restrict__ T_out,
                        int* __restrict__ cnt_out, float* __restrict__ err_out) {
  extern __shared__ int s_idx[];       // the hypothesis's `sample` slots
  __shared__ int s_cnt[kThreads];
  __shared__ float s_err[kThreads];
  __shared__ int s_warp[kThreads / 32];
  __shared__ float s_pose[12];

  const size_t z = blockIdx.y;
  const size_t hyp = z * gridDim.x + blockIdx.x;
  p1 += z * (size_t)n * 3;
  p2 += z * (size_t)n * 3;
  w += z * (size_t)n;
  valid += z * (size_t)n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Pose P;
  if (blockIdx.x == 0) {
    // hypothesis 0 is the identity (the reference's fallback)
    set_identity(P);
  } else {
    // rank of each valid slot: thread tid owns the slots [lo, hi)
    const int chunk = (n + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
    int local = 0;
    for (int i = lo; i < hi; ++i) local += valid[i] ? 1 : 0;
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    for (int s = tid; s < sample; s += kThreads) s_idx[s] = 0;   // a draw beyond the valid slots takes slot 0
    __syncthreads();
    int before = 0, n_valid = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      before += (k < warp) ? s_warp[k] : 0;
      n_valid += s_warp[k];
    }
    const int first = before + incl - local;   // rank of this thread's first valid slot
    const int nv = max(n_valid, 1);
    for (int s = 0; s < sample; ++s) {
      int d;
      if (draws != nullptr) {
        d = draws[hyp * sample + s];
      } else {
        d = min((int)floorf(u[hyp * sample + s] * (float)nv), nv - 1);
      }
      if (d >= first && d < first + local) {
        int k = d - first;
        for (int i = lo; i < hi; ++i) {
          if (valid[i]) {
            if (k == 0) {
              s_idx[s] = i;
              break;
            }
            --k;
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      // weighted_rigid_transform's order over the drawn slots, one pass a
      // step (no per-sample array, so S is a loop bound): the weight sum,
      // the normalized weights' centroids, the cross-covariance
      float wsum = 0.0f;
      for (int s = 0; s < sample; ++s) {
        const int i = s_idx[s];
        wsum += w[i] * (valid[i] ? 1.0f : 0.0f);
      }
      const float den = (wsum < 1e-12f) ? 1e-12f : wsum;
      float c1[3] = {0.0f, 0.0f, 0.0f}, c2[3] = {0.0f, 0.0f, 0.0f};
      for (int s = 0; s < sample; ++s) {
        const int i = s_idx[s];
        const float sw = w[i] * (valid[i] ? 1.0f : 0.0f) / den;
        for (int k = 0; k < 3; ++k) {
          c1[k] += sw * p1[3 * i + k];
          c2[k] += sw * p2[3 * i + k];
        }
      }
      float S[9];
      for (int k = 0; k < 9; ++k) S[k] = 0.0f;
      for (int s = 0; s < sample; ++s) {
        const int i = s_idx[s];
        const float sw = w[i] * (valid[i] ? 1.0f : 0.0f) / den;
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b)
            S[3 * a + b] += sw * (p1[3 * i + a] - c1[a]) * (p2[3 * i + b] - c2[b]);
      }
      Pose F;
      horn_pose(S, c1, c2, wsum, F);
      for (int k = 0; k < 9; ++k) s_pose[k] = F.r[k];
      for (int k = 0; k < 3; ++k) s_pose[9 + k] = F.t[k];
    }
    __syncthreads();
    for (int k = 0; k < 9; ++k) P.r[k] = s_pose[k];
    for (int k = 0; k < 3; ++k) P.t[k] = s_pose[9 + k];
  }

  int cnt = 0;
  float err = 0.0f;
  for (int i = tid; i < n; i += kThreads) {
    float e;
    const bool in = pair_inlier(md, P, p1[3 * i], p1[3 * i + 1], p1[3 * i + 2], p2[3 * i],
                                p2[3 * i + 1], p2[3 * i + 2], e);
    if (in && valid[i]) {
      cnt += 1;
      err += e;
    }
  }
  reduce_cnt_err(cnt, err, s_cnt, s_err);
  if (tid == 0) {
    store_pose(P, T_out + hyp * 16);
    cnt_out[hyp] = s_cnt[0];
    err_out[hyp] = s_err[0];
  }
}

// ---------------------------------------------------------------------------
// kernel B: select the winner and refine it, one block per problem
// ---------------------------------------------------------------------------

// Sum of K floats per thread over the block; every thread gets the result.
// Warp butterflies, then the warps' partials in sequence: a fixed order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
  __syncthreads();                     // the previous sum's readers are done
  if (lane == 0)
    for (int k = 0; k < K; ++k) s_red[warp * K + k] = v[k];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float acc = s_red[k];
    for (int wp = 1; wp < kSelWarps; ++wp) acc += s_red[wp * K + k];
    v[k] = acc;
  }
}

// is (ra, ia) ahead of (rb, ib) for torch.argmax: the larger rank, NaN
// above everything, the lower index among equals
__device__ __forceinline__ bool rank_ahead(float ra, int ia, float rb, int ib) {
  const bool na = isnan(ra), nb = isnan(rb);
  if (na != nb) return na;
  if (!na && ra != rb) return ra > rb;
  return ia < ib;
}

// Views of one problem's correspondences as planes: in kernel B's dynamic
// shared memory, or past its capacity in a global scratch buffer (the same
// layout, 31 bytes a slot: seven f32 planes, then the validity flags and two
// planes of inlier flags).
struct SelPlanes {
  float *x1, *y1, *z1, *x2, *y2, *z2, *w;
  unsigned char *valid, *inl_a, *inl_b;
};

__device__ __forceinline__ SelPlanes carve_planes(char* base, int n) {
  SelPlanes sm;
  sm.x1 = reinterpret_cast<float*>(base);
  sm.y1 = sm.x1 + n;
  sm.z1 = sm.y1 + n;
  sm.x2 = sm.z1 + n;
  sm.y2 = sm.x2 + n;
  sm.z2 = sm.y2 + n;
  sm.w = sm.z2 + n;
  sm.valid = reinterpret_cast<unsigned char*>(sm.w + n);
  sm.inl_a = sm.valid + n;
  sm.inl_b = sm.inl_a + n;
  return sm;
}

// Score pose P on the block's correspondences: writes the inlier flags and
// returns (count, sum of errors) in every thread. The count rides the float
// reduction: integers up to N < 2^24 add exactly in f32.
__device__ __forceinline__ void score_block(const Pose& P, const SelPlanes& sm, int n,
                                            const Model& md, unsigned char* inl, float* s_red,
                                            int& cnt_out, float& err_out) {
  float acc[2] = {0.0f, 0.0f};        // count, sum of errors
  for (int i = threadIdx.x; i < n; i += kSelThreads) {
    float e;
    const bool ok = pair_inlier(md, P, sm.x1[i], sm.y1[i], sm.z1[i], sm.x2[i], sm.y2[i],
                                sm.z2[i], e) && sm.valid[i];
    inl[i] = ok ? 1 : 0;
    if (ok) {
      acc[0] += 1.0f;
      acc[1] += e;
    }
  }
  block_sum<2>(acc, s_red);
  cnt_out = (int)acc[0];
  err_out = acc[1];
}

// y = L^-1 b for the lower-triangular L = [[l11], [l21, l22], [l31, l32, l33]]
__device__ __forceinline__ void lower_solve(const float (&L)[6], float b0, float b1, float b2,
                                            float (&y)[3]) {
  y[0] = b0 / L[0];
  y[1] = (b1 - L[1] * y[0]) / L[2];
  y[2] = (b2 - L[3] * y[0] - L[4] * y[1]) / L[5];
}

// One inlier's contribution (wm = 1; 0 for the others, multiplied as the
// plain version multiplies) to the 21 upper entries of H and the 6 of g of
// refine_mahalanobis (rgbdslam_tpu/solvers/ransac_se3.py:211-260): the
// covariance C = R diag(s1) R^T + diag(s2), its Cholesky factor L (_chol3,
// each pivot floored at 1e-20 before its root), the whitened residual
// L^-1 (q - p2) and Jacobian L^-1 [I | -hat(q)], q = R p1 + t.
__device__ __forceinline__ void polish_point(const float (&R)[3][3], const float (&t)[3],
                                             const Noise& nz, float x1, float y1, float z1,
                                             float x2, float y2, float z2, float wm,
                                             float (&acc)[27]) {
  float a[3], b[3];
  sigma_diag(nz, z1, a[0], a[1], a[2]);
  sigma_diag(nz, z2, b[0], b[1], b[2]);
  const float x[3] = {x1, y1, z1};
  float q[3], d[3];
  for (int i = 0; i < 3; ++i) {
    q[i] = R[i][0] * x[0] + R[i][1] * x[1] + R[i][2] * x[2] + t[i];
  }
  d[0] = q[0] - x2;
  d[1] = q[1] - y2;
  d[2] = q[2] - z2;
  float C[3][3];
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l)
      C[i][l] = R[i][0] * a[0] * R[l][0] + R[i][1] * a[1] * R[l][1]
              + R[i][2] * a[2] * R[l][2] + (i == l ? b[i] : 0.0f);
  float L[6];
  const float c00 = C[0][0] < 1e-20f ? 1e-20f : C[0][0];
  L[0] = sqrtf(c00);
  L[1] = C[1][0] / L[0];
  L[3] = C[2][0] / L[0];
  const float c11 = C[1][1] - L[1] * L[1];
  L[2] = sqrtf(c11 < 1e-20f ? 1e-20f : c11);
  L[4] = (C[2][1] - L[3] * L[1]) / L[2];
  const float c22 = C[2][2] - L[3] * L[3] - L[4] * L[4];
  L[5] = sqrtf(c22 < 1e-20f ? 1e-20f : c22);
  float Wd[3], WJ[6][3];
  lower_solve(L, d[0], d[1], d[2], Wd);
  lower_solve(L, 1.0f, 0.0f, 0.0f, WJ[0]);
  lower_solve(L, 0.0f, 1.0f, 0.0f, WJ[1]);
  lower_solve(L, 0.0f, 0.0f, 1.0f, WJ[2]);
  lower_solve(L, 0.0f, -q[2], q[1], WJ[3]);
  lower_solve(L, q[2], 0.0f, -q[0], WJ[4]);
  lower_solve(L, -q[1], q[0], 0.0f, WJ[5]);
  for (int j = 0; j < 6; ++j) {
    for (int k = j; k < 6; ++k)
      acc[tri6(j, k)] += (WJ[j][0] * WJ[k][0] + WJ[j][1] * WJ[k][1] + WJ[j][2] * WJ[k][2]) * wm;
    acc[21 + j] += (WJ[j][0] * Wd[0] + WJ[j][1] * Wd[1] + WJ[j][2] * Wd[2]) * wm;
  }
}

// kShared: the problem's planes in dynamic shared memory (31 N bytes);
// else in `scratch`, one `stride`-byte region a problem, read through L2.
template <bool kShared>
__global__ void __launch_bounds__(kSelThreads)
ransac_select_refine_kernel(const float* __restrict__ T_h, const int* __restrict__ cnt_h,
                            const float* __restrict__ err_h, int h,
                            const float* __restrict__ p1, const float* __restrict__ p2,
                            const float* __restrict__ w,
                            const unsigned char* __restrict__ valid, int n, Model md,
                            int refine_iters, int polish_iters, int min_inliers,
                            char* __restrict__ scratch, size_t stride,
                            float* __restrict__ T_out, unsigned char* __restrict__ inl_out,
                            int* __restrict__ cnt_out, float* __restrict__ rmse_out,
                            unsigned char* __restrict__ success_out) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_red[kSelWarps * 27];
  __shared__ float s_rank[kSelWarps];
  __shared__ int s_best[kSelWarps];
  __shared__ float s_pose[12];

  const size_t z = blockIdx.x;
  T_h += z * (size_t)h * 16;
  cnt_h += z * (size_t)h;
  err_h += z * (size_t)h;
  p1 += z * (size_t)n * 3;
  p2 += z * (size_t)n * 3;
  w += z * (size_t)n;
  valid += z * (size_t)n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const SelPlanes sm =
      carve_planes(kShared ? reinterpret_cast<char*>(s_dyn) : scratch + z * stride, n);

  int some_valid = 0;
  for (int i = tid; i < n; i += kSelThreads) {
    sm.x1[i] = p1[3 * i];
    sm.y1[i] = p1[3 * i + 1];
    sm.z1[i] = p1[3 * i + 2];
    sm.x2[i] = p2[3 * i];
    sm.y2[i] = p2[3 * i + 1];
    sm.z2[i] = p2[3 * i + 2];
    sm.w[i] = w[i];
    const unsigned char v = valid[i] ? 1 : 0;
    sm.valid[i] = v;
    some_valid |= v;
  }
  const bool any_valid = __syncthreads_or(some_valid) != 0;

  // arg max of rank = count * 1e4 - min(rmse, 9e3), first index on ties
  float best_rank = -INFINITY;
  int best = INT_MAX;
  for (int k = tid; k < h; k += kSelThreads) {
    const float rm = rmse_of(cnt_h[k], err_h[k]);
    const float rank = (float)cnt_h[k] * 1e4f - ((rm > 9e3f) ? 9e3f : rm);
    if (rank_ahead(rank, k, best_rank, best)) {
      best_rank = rank;
      best = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float orank = __shfl_xor_sync(kFull, best_rank, off);
    const int oidx = __shfl_xor_sync(kFull, best, off);
    if (rank_ahead(orank, oidx, best_rank, best)) {
      best_rank = orank;
      best = oidx;
    }
  }
  if (lane == 0) {
    s_rank[warp] = best_rank;
    s_best[warp] = best;
  }
  __syncthreads();
  best_rank = s_rank[0];
  best = s_best[0];
  for (int wp = 1; wp < kSelWarps; ++wp) {
    if (rank_ahead(s_rank[wp], s_best[wp], best_rank, best)) {
      best_rank = s_rank[wp];
      best = s_best[wp];
    }
  }

  Pose P;
  load_pose(T_h + (size_t)best * 16, P);
  unsigned char* inl = sm.inl_a;
  unsigned char* inl_new = sm.inl_b;
  int cnt;
  float err;
  score_block(P, sm, n, md, inl, s_red, cnt, err);
  float rmse = rmse_of(cnt, err);

  for (int it = 0; it < refine_iters; ++it) {
    // weighted fit on the inlier set: weight sum, centroids, cross-covariance
    float ws[1] = {0.0f};
    for (int i = tid; i < n; i += kSelThreads) ws[0] += sm.w[i] * (float)inl[i];
    block_sum<1>(ws, s_red);
    const float wsum = ws[0];
    const float den = (wsum < 1e-12f) ? 1e-12f : wsum;
    float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < n; i += kSelThreads) {
      const float wn = sm.w[i] * (float)inl[i] / den;
      c[0] += wn * sm.x1[i];
      c[1] += wn * sm.y1[i];
      c[2] += wn * sm.z1[i];
      c[3] += wn * sm.x2[i];
      c[4] += wn * sm.y2[i];
      c[5] += wn * sm.z2[i];
    }
    block_sum<6>(c, s_red);
    float S[9];
    for (int k = 0; k < 9; ++k) S[k] = 0.0f;
    for (int i = tid; i < n; i += kSelThreads) {
      const float wn = sm.w[i] * (float)inl[i] / den;
      const float q1[3] = {sm.x1[i] - c[0], sm.y1[i] - c[1], sm.z1[i] - c[2]};
      const float q2[3] = {sm.x2[i] - c[3], sm.y2[i] - c[4], sm.z2[i] - c[5]};
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) S[3 * a + b] += wn * q1[a] * q2[b];
    }
    block_sum<9>(S, s_red);
    if (tid == 0) {
      Pose F;
      horn_pose(S, c, c + 3, wsum, F);
      for (int k = 0; k < 9; ++k) s_pose[k] = F.r[k];
      for (int k = 0; k < 3; ++k) s_pose[9 + k] = F.t[k];
    }
    __syncthreads();
    Pose P_new;
    for (int k = 0; k < 9; ++k) P_new.r[k] = s_pose[k];
    for (int k = 0; k < 3; ++k) P_new.t[k] = s_pose[9 + k];
    int cnt2;
    float err2;
    score_block(P_new, sm, n, md, inl_new, s_red, cnt2, err2);
    const float rmse2 = rmse_of(cnt2, err2);
    // keep a refit only if it loses no inliers and no accuracy
    if (cnt2 >= cnt && rmse2 <= rmse) {
      P = P_new;
      cnt = cnt2;
      rmse = rmse2;
      unsigned char* tmp = inl;
      inl = inl_new;
      inl_new = tmp;
    }
  }

  // the Mahalanobis polish (mahalanobis_refine): polish_iters whitened
  // Gauss-Newton rounds from the refined pose over its inliers, each a
  // pass, one block sum of the 27 normal-equation entries and thread 0's
  // damped pivoted solve and left exp-compose; kept if finite with >= 3
  // inliers, then only if its own scoring loses no inliers and no accuracy
  // (ransac_se3.py:353-361)
  if (polish_iters > 0) {
    float R[3][3], t[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) R[i][j] = P.r[3 * i + j];
      t[i] = P.t[i];
    }
    for (int it = 0; it < polish_iters; ++it) {
      float acc[27];
      for (int k = 0; k < 27; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += kSelThreads)
        polish_point(R, t, md.nz, sm.x1[i], sm.y1[i], sm.z1[i], sm.x2[i], sm.y2[i], sm.z2[i],
                     inl[i] ? 1.0f : 0.0f, acc);
      block_sum<27>(acc, s_red);
      if (tid == 0) {
        float Hs[21], g[6], xi[6];
        for (int k = 0; k < 21; ++k) Hs[k] = acc[k];
        for (int k = 0; k < 6; ++k) g[k] = acc[21 + k];
        solve6_neg(Hs, g, xi);
        se3_exp_compose(xi, R, t);
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) s_pose[3 * i + j] = R[i][j];
          s_pose[9 + i] = t[i];
        }
      }
      __syncthreads();
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) R[i][j] = s_pose[3 * i + j];
        t[i] = s_pose[9 + i];
      }
    }
    Pose P_m;
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        P_m.r[3 * i + j] = R[i][j];
        finite = finite && isfinite(R[i][j]);
      }
      P_m.t[i] = t[i];
      finite = finite && isfinite(t[i]);
    }
    if (finite && cnt >= 3) {
      int cnt_m;
      float err_m;
      score_block(P_m, sm, n, md, inl_new, s_red, cnt_m, err_m);
      const float rmse_m = rmse_of(cnt_m, err_m);
      if (cnt_m >= cnt && rmse_m <= rmse) {
        P = P_m;
        cnt = cnt_m;
        rmse = rmse_m;
        inl = inl_new;
      }
    }
  }

  const bool success = cnt >= min_inliers && any_valid;
  __syncthreads();                     // the last scoring's flags are written
  for (int i = tid; i < n; i += kSelThreads)
    inl_out[z * (size_t)n + i] = (success && inl[i]) ? 1 : 0;
  if (tid == 0) {
    store_pose(P, T_out + z * 16);
    cnt_out[z] = cnt;
    rmse_out[z] = rmse;
    success_out[z] = success ? 1 : 0;
  }
}

}  // namespace

// The scorer alone in one launch: `chunks` (1 to kMaxChunks) blocks of a
// cluster share each group of `group` (4 or 8) hypotheses' points.
extern "C" int rgbd_mahal_hypothesis_scores(const void* T, const void* p1,
                                            const void* p2, const void* s1,
                                            const void* s2, const void* valid,
                                            int batch, int h, int n, int chunks, int group,
                                            float th, void* cnt, void* err, void* stream) {
  if (batch < 1 || h < 1 || n < 0 || chunks < 1 || chunks > kMaxChunks ||
      (group != 4 && group != 8))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((h + group - 1) / group, chunks, batch);
  cfg.blockDim = dim3(kScoreThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = chunks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int span = (n + chunks - 1) / chunks;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, group == 8 ? mahal_scores_kernel<8> : mahal_scores_kernel<4>, (const float*)T,
      (const float*)p1, (const float*)p2, (const float*)s1, (const float*)s2,
      (const unsigned char*)valid, h, n, span, th, (int*)cnt, (float*)err);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The whole RANSAC: kernel A over (h, batch) blocks, then kernel B over
// batch blocks, on one stream. Exactly one of u (f32 uniforms in [0, 1)) and
// draws (int32 ranks among the valid slots), both (batch, h, sample), is not
// null. model: an ErrorModel; params (host, 11 floats): cov_x, cov_y,
// depth_std_factor, th (the largest inlier m^2), the distance threshold,
// the adaptive coefficient, the pixel threshold, fx, fy, cx, cy.
// polish_iters > 0 runs the Mahalanobis polish. scratch: null, or past the
// shared memory a block may hold (31 n bytes) batch regions of `stride`
// bytes for kernel B's planes.
extern "C" int rgbd_ransac_se3(const void* p1, const void* p2, const void* w,
                               const void* valid, const void* u, const void* draws,
                               int batch, int h, int n, int sample, int model,
                               const float* params, int refine_iters, int polish_iters,
                               int min_inliers, void* scratch, long long stride, void* T_h,
                               void* cnt_h, void* err_h, void* T, void* inliers, void* cnt,
                               void* rmse, void* success, void* stream) {
  if (batch < 1 || h < 1 || n < 1 || sample < 1 || model < kMahalanobis || model > kBoth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Model md;
  md.kind = model;
  md.nz = {params[0], params[1], params[2]};
  md.th = params[3];
  md.thr_m = params[4];
  md.coeff = params[5];
  md.reproj_th = params[6];
  md.fx = params[7];
  md.fy = params[8];
  md.cx = params[9];
  md.cy = params[10];
  cudaError_t e;
  const int idx_bytes = sample * (int)sizeof(int);
  if (idx_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(ransac_fit_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, idx_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ransac_fit_score_kernel<<<dim3(h, batch), kThreads, idx_bytes, s>>>(
      (const float*)p1, (const float*)p2, (const float*)w, (const unsigned char*)valid,
      (const float*)u, (const int*)draws, n, sample, md, (float*)T_h, (int*)cnt_h,
      (float*)err_h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (scratch != nullptr) {
    ransac_select_refine_kernel<false><<<batch, kSelThreads, 0, s>>>(
        (const float*)T_h, (const int*)cnt_h, (const float*)err_h, h, (const float*)p1,
        (const float*)p2, (const float*)w, (const unsigned char*)valid, n, md, refine_iters,
        polish_iters, min_inliers, (char*)scratch, (size_t)stride, (float*)T,
        (unsigned char*)inliers, (int*)cnt, (float*)rmse, (unsigned char*)success);
    return (int)cudaGetLastError();
  }
  const int bytes = n * (7 * 4 + 3);   // seven f32 planes and three flag planes
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(ransac_select_refine_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ransac_select_refine_kernel<true><<<batch, kSelThreads, bytes, s>>>(
      (const float*)T_h, (const int*)cnt_h, (const float*)err_h, h, (const float*)p1,
      (const float*)p2, (const float*)w, (const unsigned char*)valid, n, md, refine_iters,
      polish_iters, min_inliers, nullptr, 0, (float*)T, (unsigned char*)inliers, (int*)cnt,
      (float*)rmse, (unsigned char*)success);
  return (int)cudaGetLastError();
}
