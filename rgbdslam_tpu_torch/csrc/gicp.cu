// K4: the whole plane-to-plane GICP refinement (Gauss-Newton loop,
// convergence gate, fallback) in one launch, and K5: one normal-equation
// build of the same problem.
//
// K4 replaces: rgbdslam_tpu/ops/pallas_kernels.py gicp_refine_kernel (790-825),
// bodies _gicp_loop_kernel (731-762), _gicp_iteration (559-632),
// _se3_exp_compose (674-707), and the gate XLA fused behind it in
// rgbdslam_tpu/solvers/icp.py gicp_refine (225-243); the solve of
// _chol6_solve_neg (635-671) is replaced, see solve6_neg.
// K5 replaces: gicp_gn_normal_equations (828-862), body _gicp_gn_kernel
// (710-728): K4's round without the solve. Both entries share the per-point
// device function accumulate_point and the block reduction reduce_sums, with
// the same number of threads, so their sums agree bit for bit at the same
// pose.
//
// Each of `iters` rounds: q = R p1 + t, r = q - p2; S = R C1 R^T + C2 and
// W = S^-1 by adjugate; gate |r|^2 < max_dist^2 on valid slots; reduce the
// 21 upper-triangular H entries, the 6 b entries, the cost and the count
// over N; solve (H + 1e-6 I) x = -b (6x6, pivoted elimination);
// left-compose exp(x) onto (R, t). Then the finish: the number of valid
// slots, the number of them within max_dist of their partner at the final
// pose (|r| < max_dist, the square root taken as the plain version takes
// it), and converged = both counts >= min_matches and a finite pose; the
// output pose is the final one if converged, else T_init.
//
// What bounds it on an H100: at N = 1024 and 10 rounds the arithmetic is
// ~2 MFLOP and the inputs are 100 KB, nothing next to the card's rates; the
// cost is latency: ten dependent rounds on one SM, each a per-point pass, a
// block reduction and a serial 6x6 solve.
//
// Design: one block of 512 threads. The inputs are read from global memory
// once into dynamic shared memory, as 19 planes of N floats (p1, p2, the six
// upper-triangular entries of C1 and of C2, the validity flag), so every
// later read is conflict-free and no round touches global memory, up to
// 3,000 points (76 bytes each within the 227 KB a block may use, less 2 KB
// of static shared memory). Past that (SlamSystem allows 4,096 features) the
// same planes go to a global scratch buffer that the wrapper passes, 311 KB
// at N = 4,096, which stays in L2; the same thread-to-point map, per-point
// function and reduction tree run on them, so the arithmetic does not depend
// on where the planes live. With IcpConfig.reassociate each round and the
// finish first pair every point with its nearest valid target (a loop over
// the N targets' planes a point, every lane of a warp reading the same
// target: N^2 / 512 distance evaluations a thread and round). Each thread
// accumulates its points' 29 partial sums in registers; the sums are combined
// inside each warp by folds (the lanes split the 29 sums between them: 31
// shuffles, where a butterfly per sum takes 145 and the card moves one
// shuffle a cycle) and, after one barrier, by lanes 0-28 of
// warp 0 adding the 16 warps' partials in order; lane 0 gathers them by
// shuffles, solves the damped 6x6 system by partial-pivot elimination on a
// fully unrolled register array (the row swap is a chain of selects, so no
// index is dynamic), exp-composes and publishes R and t through shared
// memory: two barriers a round. The finish is one more pass over the planes
// and one integer reduction. K5 is the same block doing one build from global
// memory at the given pose and writing the whole result, H (both triangles),
// b, cost and gated count, as one 44-float buffer that the wrapper returns
// views of: one launch and no other device op a call. The TPU kernel's
// (24*8, N/8) planes and (32, 128) output tile are VMEM tiling and are not
// carried over.
//
// The per-point arithmetic is _gicp_iteration's (pallas_kernels.py:559-632)
// in its operation order, with the products by the Jacobian's constant 0 and
// 1 entries left out (x*1 + y*0 + z*0 is x for finite values).

#include <cuda_runtime.h>
#include <math.h>

namespace {

#include "se3_solve.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;     // 21 H + 6 b + cost + count
constexpr int kPlanes = 19;   // p1 3, p2 3, C1 6, C2 6, valid 1

// index of entry (i, j) of a symmetric 3x3 among its six upper-triangular
// entries (xx xy xz yy yz zz)
__host__ __device__ constexpr int tri3_upper(int i, int j) {
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}
__host__ __device__ constexpr int tri3(int i, int j) {
  return i <= j ? tri3_upper(i, j) : tri3_upper(j, i);
}

// One correspondence: the points, the upper triangles of the two surface
// covariances, the validity flag.
struct Point {
  float x1[3], x2[3], c1[6], c2[6];
  bool valid;
};

__device__ __forceinline__ Point load_point_global(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const float* __restrict__ C1, const float* __restrict__ C2,
    const unsigned char* __restrict__ valid, int p) {
  Point pt;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pt.x1[i] = p1[3 * p + i];
    pt.x2[i] = p2[3 * p + i];
#pragma unroll
    for (int j = i; j < 3; ++j) {
      pt.c1[tri3(i, j)] = C1[9 * p + 3 * i + j];
      pt.c2[tri3(i, j)] = C2[9 * p + 3 * i + j];
    }
  }
  pt.valid = valid[p] != 0;
  return pt;
}

// planes: [p1 x y z | p2 x y z | C1 xx xy xz yy yz zz | C2 ... | valid], each
// `stride` floats apart
__device__ __forceinline__ Point load_point_planes(const float* planes, int stride, int p) {
  Point pt;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pt.x1[i] = planes[i * stride + p];
    pt.x2[i] = planes[(3 + i) * stride + p];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    pt.c1[i] = planes[(6 + i) * stride + p];
    pt.c2[i] = planes[(12 + i) * stride + p];
  }
  pt.valid = planes[18 * stride + p] != 0.0f;
  return pt;
}

// q = R x1 + t and r = q - x2; returns |r|^2
__device__ __forceinline__ float residual(const float (&R)[3][3], const float (&t)[3],
                                          const Point& pt, float (&q)[3], float (&r)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q[i] = R[i][0] * pt.x1[0] + R[i][1] * pt.x1[1] + R[i][2] * pt.x1[2] + t[i];
    r[i] = q[i] - pt.x2[i];
  }
  return r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
}

// One correspondence's contribution to the 29 sums at pose (R, t).
__device__ __forceinline__ void accumulate_point(const float (&R)[3][3], const float (&t)[3],
                                                 const Point& pt, float max_dist2,
                                                 float (&acc)[kSums]) {
  float q[3], r[3];
  const float dist2 = residual(R, t, pt, q, r);
  // S = R C1 R^T + C2, six unique entries
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const float term = (R[i][k] * R[j][l]) * pt.c1[tri3(k, l)];
          s = (k == 0 && l == 0) ? term : s + term;
        }
      S[i][j] = s + pt.c2[tri3(i, j)];
    }
  const float a = S[0][0], b = S[0][1], c = S[0][2];
  const float d = S[1][1], e = S[1][2], f = S[2][2];
  const float A11 = d * f - e * e;
  const float A12 = c * e - b * f;
  const float A13 = b * e - c * d;
  const float A22 = a * f - c * c;
  const float A23 = b * c - a * e;
  const float A33 = a * d - b * b;
  const float det = a * A11 + b * A12 + c * A13;
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  const float w01 = A12 * inv_det, w02 = A13 * inv_det, w12 = A23 * inv_det;
  const float W[3][3] = {{A11 * inv_det, w01, w02},
                         {w01, A22 * inv_det, w12},
                         {w02, w12, A33 * inv_det}};

  const float gate = (pt.valid && dist2 < max_dist2) ? 1.0f : 0.0f;

  // J = [I3 | -hat(q)]: columns 0-2 are the unit vectors, columns 3-5 are
  // (0, -q2, q1), (q2, 0, -q0), (-q1, q0, 0). Wc[j] = W J[:, j].
  float Wc[6][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Wc[0][i] = W[i][0];
    Wc[1][i] = W[i][1];
    Wc[2][i] = W[i][2];
    Wc[3][i] = W[i][1] * -q[2] + W[i][2] * q[1];
    Wc[4][i] = W[i][0] * q[2] + W[i][2] * -q[0];
    Wc[5][i] = W[i][0] * -q[1] + W[i][1] * q[0];
  }
  // H[i][j] = J[:, i] . Wc[j], upper triangle
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i <= j) acc[tri6(i, j)] += Wc[j][i] * gate;
    if (3 <= j) acc[tri6(3, j)] += (-q[2] * Wc[j][1] + q[1] * Wc[j][2]) * gate;
    if (4 <= j) acc[tri6(4, j)] += (q[2] * Wc[j][0] + -q[0] * Wc[j][2]) * gate;
    if (5 <= j) acc[tri6(5, j)] += (-q[1] * Wc[j][0] + q[0] * Wc[j][1]) * gate;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float bi = Wc[i][0] * r[0] + Wc[i][1] * r[1] + Wc[i][2] * r[2];
    acc[21 + i] += bi * gate;
  }
  float wr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) wr[i] = W[i][0] * r[0] + W[i][1] * r[1] + W[i][2] * r[2];
  acc[27] += (r[0] * wr[0] + r[1] * wr[1] + r[2] * wr[2]) * gate;
  acc[28] += gate;
}

// One step of a warp's sum of `CNT` values a lane: lanes whose bit CNT/2 is
// clear keep the lower half of the values, the others the upper half, and
// each adds what its partner (lane ^ CNT/2) held of the half it keeps. CNT/2
// shuffles for CNT values, where a butterfly a value takes CNT.
template <int CNT>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  constexpr int half = CNT / 2;
  const bool upper = (lane & half) != 0;
#pragma unroll
  for (int j = 0; j < half; ++j) {
    const float send = upper ? v[j] : v[j + half];
    const float keep = upper ? v[j + half] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, half);
  }
}

// Sum every thread's 29 partials over the block, in a fixed order: inside a
// warp five folds (31 shuffles) leave the warp's sum k in lane k, added as a
// butterfly adds them (lanes i and i ^ 16 first, then ^ 8, ... ^ 1); lanes
// 0-28 put them into s_part; one barrier; then lane k < 29 of warp 0 adds the
// warps' partials of sum k in warp order and returns the total (other
// threads return 0). The caller keeps s_part untouched until its next
// barrier.
__device__ __forceinline__ float reduce_sums(const float (&acc)[kSums],
                                             float (*s_part)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kSums ? acc[k] : 0.0f;
  fold<32>(v, lane);
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  if (lane < kSums) s_part[warp][lane] = v[0];
  __syncthreads();
  float total = 0.0f;
  if (warp == 0 && lane < kSums) {
    total = s_part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += s_part[w][lane];
  }
  return total;
}

// The nearest valid target of q: argmin_j |q - p2_j|^2 over the valid j,
// summed as (dx^2 + dy^2) + dz^2, the first index on ties, a NaN distance
// below everything (the first NaN wins, as argmin takes it), 0 where no
// target is valid or every distance is +inf.
__device__ __forceinline__ int nearest_target(const float* planes, int stride, int n,
                                              const float (&q)[3]) {
  int best = 0;
  float bd = INFINITY;
  for (int j = 0; j < n; ++j) {
    if (planes[18 * stride + j] == 0.0f) continue;
    const float dx = q[0] - planes[3 * stride + j];
    const float dy = q[1] - planes[4 * stride + j];
    const float dz = q[2] - planes[5 * stride + j];
    const float d = dx * dx + dy * dy + dz * dz;
    if (!isnan(bd) && (d < bd || isnan(d))) {
      bd = d;
      best = j;
    }
  }
  return best;
}

// Point p with its partner: its own (x2, C2), or with `reassoc` those of its
// nearest valid target at pose (R, t).
__device__ __forceinline__ Point paired_point(const float* planes, int stride, int n, int p,
                                              bool reassoc, const float (&R)[3][3],
                                              const float (&t)[3]) {
  Point pt = load_point_planes(planes, stride, p);
  if (reassoc) {
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = R[i][0] * pt.x1[0] + R[i][1] * pt.x1[1] + R[i][2] * pt.x1[2] + t[i];
    const int j = nearest_target(planes, stride, n, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) pt.x2[i] = planes[(3 + i) * stride + j];
#pragma unroll
    for (int i = 0; i < 6; ++i) pt.c2[i] = planes[(12 + i) * stride + j];
  }
  return pt;
}

// out, as 36 words: [0:16] the output pose (the final one if converged, else
// T0), [16:32] the final pose, [32] cost and [33] gated count of the last
// round's build, [34] the number of valid slots (int), [35] converged (int,
// 0 or 1). kShared: the planes in dynamic shared memory; else in g_planes
// (kPlanes x stride floats of global memory, read through L2). kReassoc:
// every round and the finish re-pair each point with its nearest valid
// target (IcpConfig.reassociate).
template <bool kShared, bool kReassoc>
__global__ void __launch_bounds__(kThreads)
gicp_refine_kernel(const float* __restrict__ T0, const float* __restrict__ p1,
                   const float* __restrict__ p2, const float* __restrict__ C1,
                   const float* __restrict__ C2, const unsigned char* __restrict__ valid,
                   int n, int stride, int iters, float max_dist, float max_dist2,
                   int min_matches, float* __restrict__ g_planes, float* __restrict__ out) {
  extern __shared__ float s_dyn[];         // kPlanes x stride with kShared
  float* s_planes = kShared ? s_dyn : g_planes;
  __shared__ float s_part[kWarps][kSums];
  __shared__ float s_R[3][3];
  __shared__ float s_t[3];
  __shared__ int s_cnt[kWarps][2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the inputs, once: a point's 25 loads are independent and in flight
  // together
  for (int p = tid; p < n; p += kThreads) {
    const Point pt = load_point_global(p1, p2, C1, C2, valid, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_planes[i * stride + p] = pt.x1[i];
      s_planes[(3 + i) * stride + p] = pt.x2[i];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      s_planes[(6 + i) * stride + p] = pt.c1[i];
      s_planes[(12 + i) * stride + p] = pt.c2[i];
    }
    s_planes[18 * stride + p] = pt.valid ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_R[i][j] = T0[4 * i + j];
      s_t[i] = T0[4 * i + 3];
    }
  }
  __syncthreads();

  float R[3][3], t[3];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = s_R[i][j];
      t[i] = s_t[i];
    }
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;

    for (int p = tid; p < n; p += kThreads)
      accumulate_point(R, t, paired_point(s_planes, stride, n, p, kReassoc, R, t), max_dist2,
                       acc);

    const float total = reduce_sums(acc, s_part);
    if (warp == 0) {
      float Hs[21], bs[6];
#pragma unroll
      for (int k = 0; k < 21; ++k) Hs[k] = __shfl_sync(kFull, total, k);
#pragma unroll
      for (int k = 0; k < 6; ++k) bs[k] = __shfl_sync(kFull, total, 21 + k);
      const float cost = __shfl_sync(kFull, total, 27);
      const float count = __shfl_sync(kFull, total, 28);
      if (lane == 0) {
        float x[6];
        solve6_neg(Hs, bs, x);
        se3_exp_compose(x, R, t);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) s_R[i][j] = R[i][j];
          s_t[i] = t[i];
        }
        if (it == iters - 1) {
          out[32] = cost;
          out[33] = count;
        }
      }
    }
    __syncthreads();
  }

  // the finish at the final pose
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = s_R[i][j];
    t[i] = s_t[i];
  }
  int n_valid = 0, n_gated = 0;
  for (int p = tid; p < n; p += kThreads) {
    const Point pt = paired_point(s_planes, stride, n, p, kReassoc, R, t);
    float q[3], r[3];
    const float dist2 = residual(R, t, pt, q, r);
    n_valid += pt.valid ? 1 : 0;
    n_gated += (pt.valid && sqrtf(dist2) < max_dist) ? 1 : 0;
  }
  n_valid = __reduce_add_sync(kFull, n_valid);
  n_gated = __reduce_add_sync(kFull, n_gated);
  if (lane == 0) {
    s_cnt[warp][0] = n_valid;
    s_cnt[warp][1] = n_gated;
  }
  __syncthreads();
  if (tid == 0) {
    n_valid = 0;
    n_gated = 0;
    for (int w = 0; w < kWarps; ++w) {
      n_valid += s_cnt[w][0];
      n_gated += s_cnt[w][1];
    }
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) finite = finite && isfinite(R[i][j]);
      finite = finite && isfinite(t[i]);
    }
    const bool converged = n_valid >= min_matches && n_gated >= min_matches && finite;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        out[16 + 4 * i + j] = R[i][j];
        out[4 * i + j] = converged ? R[i][j] : T0[4 * i + j];
      }
      out[16 + 4 * i + 3] = t[i];
      out[4 * i + 3] = converged ? t[i] : T0[4 * i + 3];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float last = j == 3 ? 1.0f : 0.0f;
      out[16 + 12 + j] = last;
      out[12 + j] = converged ? last : T0[12 + j];
    }
    if (iters <= 0) {
      out[32] = 0.0f;
      out[33] = 0.0f;
    }
    int* out_i = reinterpret_cast<int*>(out);
    out_i[34] = n_valid;
    out_i[35] = converged ? 1 : 0;
  }
}

// The sum (of the 29) that word w of K5's 44-float result holds: H row-major
// from its upper triangle, then b, cost and count.
__device__ __forceinline__ int gn_source(int w) {
  if (w >= 36) return 21 + (w - 36);
  const int i = w / 6, j = w % 6;
  return i <= j ? tri6(i, j) : tri6(j, i);
}

// K5: one build at pose T0, no solve, written whole into out (44 floats):
// [0:36] H row-major, both triangles from the same 21 sums, so H equals H^T
// bit for bit; [36:42] b; [42] cost; [43] gated count. Lane k of warp 0
// holds sum k after the block reduction; the warp gathers the 44 words by
// two shuffles and writes them as two coalesced runs.
__global__ void __launch_bounds__(kThreads)
gicp_gn_kernel(const float* __restrict__ T0, const float* __restrict__ p1,
               const float* __restrict__ p2, const float* __restrict__ C1,
               const float* __restrict__ C2,
               const unsigned char* __restrict__ valid, int n, float max_dist2,
               float* __restrict__ out) {
  __shared__ float s_part[kWarps][kSums];
  const int tid = threadIdx.x;
  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = T0[4 * i + j];
    t[i] = T0[4 * i + 3];
  }
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  for (int p = tid; p < n; p += kThreads)
    accumulate_point(R, t, load_point_global(p1, p2, C1, C2, valid, p), max_dist2, acc);
  const float total = reduce_sums(acc, s_part);
  if (tid < 32) {                    // warp 0: lane k holds sum k
    const float lo = __shfl_sync(kFull, total, gn_source(tid));
    const float hi = __shfl_sync(kFull, total, gn_source(min(32 + tid, 43)));
    out[tid] = lo;
    if (tid < 12) out[32 + tid] = hi;
  }
}

}  // namespace

template <bool kShared, bool kReassoc>
cudaError_t launch_refine(const void* T, const void* p1, const void* p2, const void* C1,
                          const void* C2, const void* valid, int n, int stride, int iters,
                          float max_dist, float max_dist2, int min_matches, float* planes,
                          void* out, cudaStream_t st) {
  const int bytes = kShared ? kPlanes * stride * (int)sizeof(float) : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gicp_refine_kernel<kShared, kReassoc>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
    if (e != cudaSuccess) return e;
  }
  gicp_refine_kernel<kShared, kReassoc><<<1, kThreads, bytes, st>>>(
      (const float*)T, (const float*)p1, (const float*)p2, (const float*)C1, (const float*)C2,
      (const unsigned char*)valid, n, stride, iters, max_dist, max_dist2, min_matches, planes,
      (float*)out);
  return cudaGetLastError();
}

// The planes (76 (n | 1) bytes) in dynamic shared memory where `planes` is
// null, else in `planes` (19 (n | 1) floats of global memory): the wrapper
// passes it past 3,000 points. reassoc: IcpConfig.reassociate.
extern "C" int rgbd_gicp_refine_full(const void* T, const void* p1, const void* p2,
                                     const void* C1, const void* C2, const void* valid,
                                     int n, int iters, float max_dist, float max_dist2,
                                     int min_matches, int reassoc, void* planes, void* out,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int stride = n | 1;
  float* g = (float*)planes;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (g == nullptr)
    e = reassoc ? launch_refine<true, true>(T, p1, p2, C1, C2, valid, n, stride, iters,
                                            max_dist, max_dist2, min_matches, g, out, st)
                : launch_refine<true, false>(T, p1, p2, C1, C2, valid, n, stride, iters,
                                             max_dist, max_dist2, min_matches, g, out, st);
  else
    e = reassoc ? launch_refine<false, true>(T, p1, p2, C1, C2, valid, n, stride, iters,
                                             max_dist, max_dist2, min_matches, g, out, st)
                : launch_refine<false, false>(T, p1, p2, C1, C2, valid, n, stride, iters,
                                              max_dist, max_dist2, min_matches, g, out, st);
  return (int)e;
}

// out: 44 floats (H, b, cost, count), see gicp_gn_kernel.
extern "C" int rgbd_gicp_gn(const void* T, const void* p1, const void* p2,
                            const void* C1, const void* C2, const void* valid,
                            int n, float max_dist2, void* out, void* stream) {
  gicp_gn_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)p1, (const float*)p2, (const float*)C1,
      (const float*)C2, (const unsigned char*)valid, n, max_dist2,
      (float*)out);
  return (int)cudaGetLastError();
}
