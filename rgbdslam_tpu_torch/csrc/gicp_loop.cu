// K4 cut as the TPU kernel was cut: the Gauss-Newton loop of the
// plane-to-plane GICP refinement alone, one launch; the convergence gate and
// the fallback stay tensor code behind it (solvers.icp._finish_gicp).
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py gicp_refine_kernel (790-825).
// The main path runs gicp.cu's kernel, which takes the whole gicp_refine; this
// one is kept as the other side of a before/after on one card, and it can
// stamp its rounds with clock64() to show where their time goes.
//
// Each of `iters` rounds: q = R p1 + t, r = q - p2; S = R C1 R^T + C2 and
// W = S^-1 by adjugate; gate |r|^2 < max_dist^2 on valid slots; reduce the
// 21 upper-triangular H entries, the 6 b entries, the cost and the count
// over N; solve (H + 1e-6 I) x = -b (6x6, pivoted elimination);
// left-compose exp(x) onto (R, t).
//
// What bounds it on an H100: latency. One block of 256 threads; every round
// re-reads its 25 floats a point from global memory at strides of 3 and 9
// floats, combines the 29 partial sums in a shared-memory tree of 8 levels
// with a barrier each (29 serial adds a level and thread), and thread 0 alone
// runs the 6x6 elimination on a dynamically indexed local array while 255
// threads wait.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 29;   // 21 H + 6 b + cost + count
constexpr float kDamping = 1e-6f;   // as _gicp_iteration and the plain _gn_step

// x = -(H + kDamping I)^-1 b by Gaussian elimination with partial pivoting
// (Hs = 21 upper-triangular entries), as the plain version's LU solve.
// The Pallas kernel's unpivoted Cholesky (_chol6_solve_neg) returns NaN
// when H is indefinite, which real frames produce: the one-pass depth-patch
// covariances cancel in f32 and come out slightly indefinite.
__device__ void solve6_neg(const float* Hs, const float* bs, float* x) {
  float A[6][7];
  int k = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      A[i][j] = Hs[k];
      A[j][i] = Hs[k];
      ++k;
    }
    A[i][i] = A[i][i] + kDamping;
    A[i][6] = -bs[i];
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > fabsf(A[piv][c])) piv = r;
    if (piv != c)
      for (int j = c; j < 7; ++j) {
        const float tmp = A[c][j];
        A[c][j] = A[piv][j];
        A[piv][j] = tmp;
      }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[r][j] = A[r][j] - f * A[c][j];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
    for (int m = i + 1; m < 6; ++m) s = s - A[i][m] * x[m];
    x[i] = s / A[i][i];
  }
}

// (R, t) <- exp(xi) (R, t), xi = [rho | phi] (geometry/se3.exp convention)
__device__ void se3_exp_compose(const float* xi, float R[3][3], float t[3]) {
  const float rho[3] = {xi[0], xi[1], xi[2]};
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(th2);
  const bool small = th2 < 1e-12f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sinf(th)) / (th2 * th);
  const float hat[3][3] = {{0.0f, -phi[2], phi[1]},
                           {phi[2], 0.0f, -phi[0]},
                           {-phi[1], phi[0], 0.0f}};
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float hsq = (i == j) ? phi[i] * phi[j] - th2 : phi[i] * phi[j];
      const float delta = (i == j) ? 1.0f : 0.0f;
      Re[i][j] = delta + A * hat[i][j] + B * hsq;
      V[i][j] = delta + B * hat[i][j] + C * hsq;
    }
  float Rn[3][3], tn[3];
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = Re[i][0] * R[0][j] + Re[i][1] * R[1][j] + Re[i][2] * R[2][j];
    tn[i] = Re[i][0] * t[0] + Re[i][1] * t[1] + Re[i][2] * t[2] + te;
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
    t[i] = tn[i];
  }
}

__device__ __forceinline__ float sym(const float* C, int i, int j) {
  // upper-triangular entry of a symmetric 3x3 (as the Pallas packing reads it)
  return i <= j ? C[3 * i + j] : C[3 * j + i];
}

// One correspondence's contribution to the 29 sums at pose (R, t): the
// per-point arithmetic of _gicp_iteration (pallas_kernels.py:559-632), in
// its operation order.
__device__ __forceinline__ void accumulate_point(
    const float R[3][3], const float t[3], const float* __restrict__ p1,
    const float* __restrict__ p2, const float* __restrict__ C1,
    const float* __restrict__ C2, const unsigned char* __restrict__ valid,
    int p, float max_dist2, float acc[kSums]) {
  const float x1[3] = {p1[3 * p], p1[3 * p + 1], p1[3 * p + 2]};
  const float x2[3] = {p2[3 * p], p2[3 * p + 1], p2[3 * p + 2]};
  const float* c1 = C1 + 9 * p;
  const float* c2 = C2 + 9 * p;
  float q[3], r[3];
  for (int i = 0; i < 3; ++i) {
    q[i] = R[i][0] * x1[0] + R[i][1] * x1[1] + R[i][2] * x1[2] + t[i];
    r[i] = q[i] - x2[i];
  }
  // S = R C1 R^T + C2, six unique entries
  float S[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      float s = 0.0f;
      bool first = true;
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 3; ++l) {
          const float term = (R[i][k] * R[j][l]) * sym(c1, k, l);
          s = first ? term : s + term;
          first = false;
        }
      S[i][j] = s + sym(c2, i, j);
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
  const float Wu[3][3] = {{A11 * inv_det, A12 * inv_det, A13 * inv_det},
                          {0.0f, A22 * inv_det, A23 * inv_det},
                          {0.0f, 0.0f, A33 * inv_det}};
  float W[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W[i][j] = i <= j ? Wu[i][j] : Wu[j][i];

  const float dist2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float gate = (valid[p] && dist2 < max_dist2) ? 1.0f : 0.0f;

  // J = [I3 | -hat(q)]; columns as 3-vectors
  float cols[6][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f},
                      {0.0f, -q[2], q[1]}, {q[2], 0.0f, -q[0]}, {-q[1], q[0], 0.0f}};
  float Wc[6][3];
  for (int cc = 0; cc < 6; ++cc)
    for (int i = 0; i < 3; ++i)
      Wc[cc][i] = W[i][0] * cols[cc][0] + W[i][1] * cols[cc][1] + W[i][2] * cols[cc][2];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      const float hij = cols[i][0] * Wc[j][0] + cols[i][1] * Wc[j][1] + cols[i][2] * Wc[j][2];
      acc[k++] += hij * gate;
    }
  for (int i = 0; i < 6; ++i) {
    const float bi = Wc[i][0] * r[0] + Wc[i][1] * r[1] + Wc[i][2] * r[2];
    acc[21 + i] += bi * gate;
  }
  float wr[3];
  for (int i = 0; i < 3; ++i) wr[i] = W[i][0] * r[0] + W[i][1] * r[1] + W[i][2] * r[2];
  acc[27] += (r[0] * wr[0] + r[1] * wr[1] + r[2] * wr[2]) * gate;
  acc[28] += gate;
}

// Sum every thread's 29 partials over the block; the totals land in
// s_red[k][0] (a shared-memory tree, so the order is fixed).
__device__ __forceinline__ void reduce_sums(float (*s_red)[kThreads],
                                            const float acc[kSums], int tid) {
  for (int k = 0; k < kSums; ++k) s_red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride)
      for (int k = 0; k < kSums; ++k) s_red[k][tid] += s_red[k][tid + stride];
    __syncthreads();
  }
}

// clocks (kStamp): thread 0's clock64() cycles summed over the rounds, as
// [accumulate, reduce, solve and compose, the whole kernel].
template <bool kStamp>
__global__ void __launch_bounds__(kThreads)
gicp_kernel(const float* __restrict__ T0, const float* __restrict__ p1,
            const float* __restrict__ p2, const float* __restrict__ C1,
            const float* __restrict__ C2,
            const unsigned char* __restrict__ valid, int n, int iters,
            float max_dist2, float* __restrict__ out, long long* __restrict__ clocks) {
  long long c_acc = 0, c_red = 0, c_solve = 0, c_start = 0;
  if (kStamp) c_start = clock64();
  __shared__ float s_red[kSums][kThreads];
  __shared__ float s_R[3][3];
  __shared__ float s_t[3];

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) s_R[i][j] = T0[4 * i + j];
      s_t[i] = T0[4 * i + 3];
    }
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[3][3], t[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) R[i][j] = s_R[i][j];
      t[i] = s_t[i];
    }
    float acc[kSums];
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    long long c0 = 0, c1 = 0, c2 = 0;
    if (kStamp) c0 = clock64();

    for (int p = tid; p < n; p += kThreads)
      accumulate_point(R, t, p1, p2, C1, C2, valid, p, max_dist2, acc);

    if (kStamp) c1 = clock64();
    reduce_sums(s_red, acc, tid);
    if (kStamp) c2 = clock64();
    if (tid == 0) {
      float Hs[21], bs[6], x[6];
      for (int k = 0; k < 21; ++k) Hs[k] = s_red[k][0];
      for (int k = 0; k < 6; ++k) bs[k] = s_red[21 + k][0];
      solve6_neg(Hs, bs, x);
      se3_exp_compose(x, R, t);
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) s_R[i][j] = R[i][j];
        s_t[i] = t[i];
      }
      if (it == iters - 1) {
        out[16] = s_red[27][0];
        out[17] = s_red[28][0];
      }
      if (kStamp) {
        c_acc += c1 - c0;
        c_red += c2 - c1;
        c_solve += clock64() - c2;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out[4 * i + j] = s_R[i][j];
      out[4 * i + 3] = s_t[i];
    }
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
    if (iters <= 0) {
      out[16] = 0.0f;
      out[17] = 0.0f;
    }
    if (kStamp) {
      clocks[0] = c_acc;
      clocks[1] = c_red;
      clocks[2] = c_solve;
      clocks[3] = clock64() - c_start;
    }
  }
}

}  // namespace

extern "C" int rgbd_gicp_refine(const void* T, const void* p1, const void* p2,
                                const void* C1, const void* C2,
                                const void* valid, int n, int iters,
                                float max_dist2, void* out, void* clocks,
                                void* stream) {
  if (clocks != nullptr)
    gicp_kernel<true><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)T, (const float*)p1, (const float*)p2, (const float*)C1,
        (const float*)C2, (const unsigned char*)valid, n, iters, max_dist2,
        (float*)out, (long long*)clocks);
  else
    gicp_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)T, (const float*)p1, (const float*)p2, (const float*)C1,
        (const float*)C2, (const unsigned char*)valid, n, iters, max_dist2,
        (float*)out, nullptr);
  return (int)cudaGetLastError();
}
