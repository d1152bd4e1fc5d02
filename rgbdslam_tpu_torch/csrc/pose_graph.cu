// The SE(3) pose-graph Levenberg-Marquardt iteration of
// solvers/pose_graph.py in two launches around the dense solve:
// pose_graph_ne_kernel (the normal equations, the gauge prior and the
// Marquardt damping) and pose_graph_trial_kernel (the trial step, its
// robust cost and the masked accept with the lambda schedule).
//
// Replaces, in the plain iteration: edge_blocks (torch.func.jacfwd under
// vmap of edge_residual, the Huber reweighting and three einsums), the
// index_put_ scatters of _normal_equations, the damping of _damped_step,
// se3.exp and the left update, graph_cost and _lm_update: ~600 device
// launches an iteration. The damped solve between the two kernels stays
// torch.linalg.solve_ex. The JAX package has no kernel here (XLA compiled
// its jacfwd program whole).
//
// Per edge, r = log(Z^-1 Ta^-1 Tb) by se3.log_smooth's formula and
// branches, and in closed form its Jacobians with respect to left
// increments of both endpoints: Jb = J_r^-1(r) Ad(Tb^-1), Ja = -Jb. With
// r = [rho, phi], Phi = hat(phi), P = hat(rho), theta = |phi|:
//   J_r^-1(r) = [[A, B], [0, A]],
//   A = I + Phi / 2 + c1 Phi^2,
//   B = P / 2 + c1 (Phi P + P Phi) + c2 (Phi^2 P Phi + Phi P Phi^2),
//   c1 = (1 - G) / theta^2, c2 = (1 - G + theta G' / 2) / theta^4,
//   G = (theta / 2) cot(theta / 2),
// (f(-ad r) for f(x) = x / (e^x - 1), reduced by ad's minimal polynomial
// x (x^2 + theta^2)^2). Below theta^2 = 1 c1 and c2 come from four terms of
// their series (the next terms are under 3e-7 of them): the closed forms
// cancel in f32 there, as jacfwd's f32 derivatives of log_smooth do (up to
// 2e-4 off at theta ~ 1e-3, where these stay within 1e-6 of float64).
// So Jb = [[M, N], [0, M]] with M = A Rb^T and N = B Rb^T - M hat(tb), and
// one 6x6 JtJ and Jt r per edge give every block: Haa = Hbb = w JtJ,
// Hab = Hba = -w JtJ, gb = -ga = w Jt r, w = weight * the Huber IRLS weight.
//
// What bounds it on an H100: at K = 119 vertices and E ~ 260 edges an
// iteration is ~1 MFLOP and writes H, (6K)^2 x 4 B = 2 MB, once; the time is
// the two launches' latency, far under the dense solve's.
//
// Design. pose_graph_ne_kernel: a block of 128 threads a vertex i, owning
// rows 6i..6i+5 of H (in dynamic shared memory, 24 x 6K bytes) and of g.
// The block walks the edges in chunks of 128, a thread an edge; a thread
// whose edge touches i builds its edge's 21 + 6 sums in registers and
// leaves them in shared memory. Then thread (p, q) of the first 36 adds
// entry (p, q) of each touching edge's blocks, in edge order, into the
// diagonal block (i, i) and the block (i, other end): every entry of the
// row block has one owner thread, so the sums need no atomics and come out
// in a fixed order, the same bits every call (as the plain index_put_'s
// sorted accumulation on the card). Each edge is linearized by both of its
// end vertices' blocks. The gauge prior and Marquardt's damping go onto the
// block's diagonal, H_dd <- (H_dd + boost_d) + lam H_dd with boost_d = 1e9
// on a fixed vertex, else lam + 1e-8 (_damped_step's order).
// The rows are written once, whole, zeros included: no fill before the
// launch. Block 0 also sums every edge's robust cost, in edge order.
// pose_graph_trial_kernel: one block of 512 threads. The vertices' candidate
// poses exp(xi) X (xi = -solution, 0 on fixed vertices; se3.exp's formula)
// go to a scratch buffer; after a barrier the block sums the edges' robust
// costs at them in a fixed order, thread 0 compares the sum with the
// iteration's cost and sets lambda (x1/3 on accept, x2 on reject, clamped to
// [1e-9, 1e8]) and the cost, and the block writes the accepted poses or the
// current ones. Without `adaptive` (fixed-damping Gauss-Newton) the
// candidate is taken and its cost is not computed.
//
// nvcc runs with -fmad=false; each formula keeps the plain version's order
// of operations, so a residual or a cost rounds as the plain one does up to
// the libraries' sin / cos / atan2 and the order of sums.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowThreads = 128;    // threads of a vertex's block in pose_graph_ne_kernel
constexpr int kSlot = 29;           // a chunk slot: 21 H + 6 g + the cost term, padded
constexpr int kTrialThreads = 512;  // the one block of pose_graph_trial_kernel

// index of entry (i, j), i <= j, among the 21 upper-triangular entries of a 6x6
__host__ __device__ constexpr int tri6(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

struct Rigid {
  float R[3][3];
  float t[3];
};

__device__ __forceinline__ Rigid load_rigid(const float* T) {
  Rigid o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) o.R[i][j] = T[4 * i + j];
    o.t[i] = T[4 * i + 3];
  }
  return o;
}

// se3.inverse: [R^T | -(R^T t)]
__device__ __forceinline__ Rigid inverse(const Rigid& T) {
  Rigid o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.R[i][j] = T.R[j][i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.t[i] = -(o.R[i][0] * T.t[0] + o.R[i][1] * T.t[1] + o.R[i][2] * T.t[2]);
  return o;
}

// the 4x4 product of two rigid transforms
__device__ __forceinline__ Rigid compose(const Rigid& X, const Rigid& Y) {
  Rigid o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.R[i][j] = X.R[i][0] * Y.R[0][j] + X.R[i][1] * Y.R[1][j] + X.R[i][2] * Y.R[2][j];
    o.t[i] = X.R[i][0] * Y.t[0] + X.R[i][1] * Y.t[1] + X.R[i][2] * Y.t[2] + X.t[i];
  }
  return o;
}

__device__ __forceinline__ void hat(const float (&v)[3], float (&W)[3][3]) {
  W[0][0] = 0.0f;
  W[0][1] = -v[2];
  W[0][2] = v[1];
  W[1][0] = v[2];
  W[1][1] = 0.0f;
  W[1][2] = -v[0];
  W[2][0] = -v[1];
  W[2][1] = v[0];
  W[2][2] = 0.0f;
}

__device__ __forceinline__ void matmul3(const float (&X)[3][3], const float (&Y)[3][3],
                                        float (&O)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      O[i][j] = X[i][0] * Y[0][j] + X[i][1] * Y[1][j] + X[i][2] * Y[2][j];
}

// se3.log_smooth of a rigid transform: r = [rho, phi]
__device__ __forceinline__ void log_smooth(const Rigid& T, float (&r)[6]) {
  // so3_log_smooth
  const float w[3] = {T.R[2][1] - T.R[1][2], T.R[0][2] - T.R[2][0], T.R[1][0] - T.R[0][1]};
  const float s = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + 1e-20f);
  const float tr = T.R[0][0] + T.R[1][1] + T.R[2][2];
  const float theta = atan2f(s, tr - 1.0f);
  const bool small_s = s < 1e-6f;
  const float s_safe = small_s ? 1.0f : s;
  const float factor = small_s ? 0.5f + theta * theta / 12.0f : theta / s_safe;
  float phi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) phi[i] = w[i] * factor;
  // the translation: rho = J_l^-1(phi) t
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = th2 < 1e-8f;
  const float th2_safe = small ? 1.0f : th2;
  const float half = 0.5f * sqrtf(th2_safe);
  const float sin_half = sinf(half);
  const float sin_half_safe = fabsf(sin_half) < 1e-8f ? 1e-8f : sin_half;
  const float coef = small ? 1.0f / 12.0f + th2 / 720.0f
                           : (1.0f - half * cosf(half) / sin_half_safe) / th2_safe;
  float W[3][3], WW[3][3];
  hat(phi, W);
  matmul3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Ji[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Ji[j] = ((i == j ? 1.0f : 0.0f) - 0.5f * W[i][j]) + coef * WW[i][j];
    r[i] = Ji[0] * T.t[0] + Ji[1] * T.t[1] + Ji[2] * T.t[2];
    r[3 + i] = phi[i];
  }
}

// edge_residual: r = log(Z^-1 Ta^-1 Tb), the product taken left to right
__device__ __forceinline__ void edge_residual(const Rigid& Ta, const Rigid& Tb,
                                              const Rigid& Z, float (&r)[6]) {
  log_smooth(compose(compose(inverse(Z), inverse(Ta)), Tb), r);
}

__device__ __forceinline__ float norm6(const float (&r)[6]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) s = s + r[i] * r[i];
  return sqrtf(s);
}

// the Huber objective's term of one edge (_huber_cost)
__device__ __forceinline__ float huber_term(float weight, float rn, float delta,
                                            float two_delta, float delta_sq) {
  return weight * (rn <= delta ? rn * rn : two_delta * rn - delta_sq);
}

// Jb = J_r^-1(r) Ad(Tb^-1), the Jacobian of r with respect to a left
// increment of Tb (see the head of the file)
__device__ __forceinline__ void jacobian_b(const float (&r)[6], const Rigid& Tb,
                                           float (&J)[6][6]) {
  const float rho[3] = {r[0], r[1], r[2]};
  const float phi[3] = {r[3], r[4], r[5]};
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float c1, c2;
  if (th2 < 1.0f) {
    c1 = 1.0f / 12.0f + th2 / 720.0f + th2 * th2 / 30240.0f + th2 * th2 * th2 / 1209600.0f;
    c2 = -1.0f / 720.0f - th2 / 15120.0f - th2 * th2 / 403200.0f
         - th2 * th2 * th2 / 11975040.0f;
  } else {
    const float half = 0.5f * sqrtf(th2);
    const float sh = sinf(half);
    const float G = half * cosf(half) / sh;
    c1 = (1.0f - G) / th2;
    c2 = (1.0f - G + 0.5f * (G - half * half / (sh * sh))) / (th2 * th2);
  }
  float F[3][3], P[3][3], FF[3][3], FP[3][3], PF[3][3];
  hat(phi, F);
  hat(rho, P);
  matmul3(F, F, FF);
  matmul3(F, P, FP);
  matmul3(P, F, PF);
  float FFPF[3][3], FPFF[3][3];
  matmul3(FF, PF, FFPF);
  matmul3(FP, FF, FPFF);
  float A[3][3], B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = ((i == j ? 1.0f : 0.0f) + 0.5f * F[i][j]) + c1 * FF[i][j];
      B[i][j] = (0.5f * P[i][j] + c1 * (FP[i][j] + PF[i][j])) + c2 * (FFPF[i][j] + FPFF[i][j]);
    }
  // M = A Rb^T, N = B Rb^T - M hat(tb)
  float M[3][3], BR[3][3], Th[3][3], MT[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[i][j] = A[i][0] * Tb.R[j][0] + A[i][1] * Tb.R[j][1] + A[i][2] * Tb.R[j][2];
      BR[i][j] = B[i][0] * Tb.R[j][0] + B[i][1] * Tb.R[j][1] + B[i][2] * Tb.R[j][2];
    }
  hat(Tb.t, Th);
  matmul3(M, Th, MT);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J[i][j] = M[i][j];
      J[i][3 + j] = BR[i][j] - MT[i][j];
      J[3 + i][j] = 0.0f;
      J[3 + i][3 + j] = M[i][j];
    }
}

// a fixed-order tree sum over the block (blockDim.x a power of two)
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* s) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
#pragma unroll
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (tid < k) s[tid] = s[tid] + s[tid + k];
    __syncthreads();
  }
  return s[0];
}

__global__ void __launch_bounds__(kRowThreads)
pose_graph_ne_kernel(const float* __restrict__ X, const long long* __restrict__ ea,
                     const long long* __restrict__ eb, const float* __restrict__ Z,
                     const float* __restrict__ weight, int n_edges, int k, float delta,
                     float two_delta, float delta_sq, float* __restrict__ H,
                     float* __restrict__ g, float* __restrict__ cost,
                     const float* __restrict__ lam, const unsigned char* __restrict__ fixed) {
  extern __shared__ float s_row[];          // rows 6i..6i+5 of H, 6 x n
  __shared__ float s_slot[kRowThreads][kSlot];
  __shared__ int s_other[kRowThreads];
  __shared__ unsigned char s_side[kRowThreads];   // bit 0: a == i, bit 1: b == i
  const int i = blockIdx.x, tid = threadIdx.x;
  const int n = 6 * k;
  for (int x = tid; x < 6 * n; x += kRowThreads) s_row[x] = 0.0f;
  float g_acc = 0.0f, c_acc = 0.0f;         // g[6i + tid - 36] (36 <= tid < 42); the cost (tid 42)
  __syncthreads();
  for (int base = 0; base < n_edges; base += kRowThreads) {
    const int e = base + tid;
    unsigned char side = 0;
    if (e < n_edges) {
      const long long a = ea[e], b = eb[e];
      const unsigned char touch = (a == i ? 1 : 0) | (b == i ? 2 : 0);
      if (touch || i == 0) {
        const Rigid Tb = load_rigid(X + 16 * b);
        float r[6];
        edge_residual(load_rigid(X + 16 * a), Tb, load_rigid(Z + 16 * (size_t)e), r);
        const float rn = norm6(r);
        const float wt = weight[e];
        s_slot[tid][27] = huber_term(wt, rn, delta, two_delta, delta_sq);
        const float w = wt * (rn <= delta ? 1.0f : delta / fmaxf(rn, 1e-12f));
        if (touch && w != 0.0f) {           // a zero-weight slot adds nothing
          float J[6][6];
          jacobian_b(r, Tb, J);
#pragma unroll
          for (int p = 0; p < 6; ++p) {
#pragma unroll
            for (int q = p; q < 6; ++q) {
              float acc = 0.0f;
#pragma unroll
              for (int m = 0; m < 6; ++m) acc = acc + J[m][p] * J[m][q];
              s_slot[tid][tri6(p, q)] = acc * w;
            }
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < 6; ++m) acc = acc + J[m][p] * r[m];
            s_slot[tid][21 + p] = acc * w;
          }
          s_other[tid] = (int)(touch == 2 ? a : b);   // a == b == i: the diagonal block
          side = touch;
        }
      }
    }
    s_side[tid] = side;
    __syncthreads();
    const int count = min(kRowThreads, n_edges - base);
    if (tid < 36) {
      // entry (p, q) of the blocks (i, i) and (i, other): Haa or Hbb, and
      // Hab = Hba = -w JtJ, from each touching edge in edge order
      const int p = tid / 6, q = tid % 6;
      const int t = tri6(min(p, q), max(p, q));
      float* row = s_row + p * n;
      for (int sl = 0; sl < count; ++sl) {
        const unsigned char sd = s_side[sl];
        if (sd == 0) continue;
        const float h = s_slot[sl][t];
        const int o = 6 * s_other[sl] + q;
        if (sd & 1) {
          row[6 * i + q] = row[6 * i + q] + h;
          row[o] = row[o] - h;
        }
        if (sd & 2) {
          row[6 * i + q] = row[6 * i + q] + h;
          row[o] = row[o] - h;
        }
      }
    } else if (tid < 42) {
      const int p = tid - 36;               // ga = -w Jt r, gb = w Jt r
      for (int sl = 0; sl < count; ++sl) {
        const unsigned char sd = s_side[sl];
        if (sd & 1) g_acc = g_acc - s_slot[sl][21 + p];
        if (sd & 2) g_acc = g_acc + s_slot[sl][21 + p];
      }
    } else if (tid == 42 && i == 0) {
      for (int sl = 0; sl < count; ++sl) c_acc = c_acc + s_slot[sl][27];
    }
    __syncthreads();
  }
  if (tid < 6) {
    // _damped_step: Hm + diag(boost) + lam diag(diagonal(Hm))
    const float l = *lam;
    const float boost = fixed[i] ? 1e9f : l + 1e-8f;
    float* hd = s_row + tid * n + 6 * i + tid;
    *hd = (*hd + boost) + l * *hd;
  }
  __syncthreads();
  float* rows = H + (size_t)6 * i * n;
  for (int x = tid; x < 6 * n; x += kRowThreads) rows[x] = s_row[x];
  if (tid >= 36 && tid < 42) g[6 * i + tid - 36] = g_acc;
  if (tid == 42 && i == 0) *cost = c_acc;
}

// exp(xi) X by se3.exp's formula, then the 4x4 product (row 3 of X is
// [0, 0, 0, 1], and so is the product's)
__device__ __forceinline__ void exp_left(const float (&xi)[6], const float* X, float* out) {
  const float rho[3] = {xi[0], xi[1], xi[2]};
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float sn = sinf(th);
  const float A = small ? 1.0f - th2 / 6.0f : sn / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sn) / (th2 * th);
  float W[3][3], WW[3][3];
  hat(phi, W);
  matmul3(W, W, WW);
  float Re[3][3], te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      Re[i][j] = (eye + A * W[i][j]) + B * WW[i][j];
      V[j] = (eye + B * W[i][j]) + C * WW[i][j];
    }
    te[i] = V[0] * rho[0] + V[1] * rho[1] + V[2] * rho[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[4 * i + j] = Re[i][0] * X[j] + Re[i][1] * X[4 + j] + Re[i][2] * X[8 + j];
    out[4 * i + 3] = Re[i][0] * X[3] + Re[i][1] * X[7] + Re[i][2] * X[11] + te[i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[12 + j] = X[12 + j];
}

__global__ void __launch_bounds__(kTrialThreads)
pose_graph_trial_kernel(const float* __restrict__ X, const float* __restrict__ sol,
                        const unsigned char* __restrict__ fixed,
                        const long long* __restrict__ ea, const long long* __restrict__ eb,
                        const float* __restrict__ Z, const float* __restrict__ weight,
                        int n_edges, int k, float delta, float two_delta, float delta_sq,
                        const float* __restrict__ cost_it, const float* __restrict__ lam,
                        int adaptive, float* Xc, float* X_out, float* state_out) {
  __shared__ float s_sum[kTrialThreads];
  __shared__ bool s_accept;
  const int tid = threadIdx.x;
  for (int v = tid; v < k; v += kTrialThreads) {
    float xi[6];
    const bool fx = fixed[v] != 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = fx ? 0.0f : -sol[6 * v + i];
    exp_left(xi, X + 16 * v, Xc + 16 * v);
  }
  __syncthreads();                   // the candidates, before the edges read them
  float c = 0.0f;
  if (adaptive) {
    for (int e = tid; e < n_edges; e += kTrialThreads) {
      float r[6];
      edge_residual(load_rigid(Xc + 16 * ea[e]), load_rigid(Xc + 16 * eb[e]),
                    load_rigid(Z + 16 * (size_t)e), r);
      c = c + huber_term(weight[e], norm6(r), delta, two_delta, delta_sq);
    }
  }
  const float cost_new = block_sum<kTrialThreads>(c, s_sum);
  if (tid == 0) {
    const float l = *lam, ci = *cost_it;
    if (adaptive) {
      // _lm_update: x1/3 on an accepted step, x2 on a rejected one
      const bool accept = cost_new < ci;
      const float next = accept ? l * (1.0f / 3.0f) : l * 2.0f;
      state_out[0] = fminf(fmaxf(next, 1e-9f), 1e8f);
      state_out[1] = accept ? cost_new : ci;
      s_accept = accept;
    } else {
      state_out[0] = l;
      state_out[1] = ci;
      s_accept = true;
    }
  }
  __syncthreads();
  const float* src = s_accept ? Xc : X;
  for (int i = tid; i < 16 * k; i += kTrialThreads) X_out[i] = src[i];
}

}  // namespace

// H (6k, 6k) damped and g (6k) written whole, cost (1). k <= 1024 (24 x 6k
// bytes of shared memory a block).
extern "C" int rgbd_pose_graph_normal_equations(
    const void* X, const void* a, const void* b, const void* Z, const void* weight,
    int n_edges, int k, float delta, float two_delta, float delta_sq, void* H, void* g,
    void* cost, const void* lam, const void* fixed, void* stream) {
  if (k < 1 || k > 1024 || n_edges < 0 || lam == nullptr || fixed == nullptr)
    return (int)cudaErrorInvalidValue;
  const int bytes = 6 * 6 * k * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_graph_ne_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  pose_graph_ne_kernel<<<k, kRowThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)X, (const long long*)a, (const long long*)b, (const float*)Z,
      (const float*)weight, n_edges, k, delta, two_delta, delta_sq, (float*)H, (float*)g,
      (float*)cost, (const float*)lam, (const unsigned char*)fixed);
  return (int)cudaGetLastError();
}

// X_out (k, 4, 4) the accepted poses, state_out [lambda, cost]; Xc (k, 4, 4)
// scratch for the candidates.
extern "C" int rgbd_pose_graph_trial(const void* X, const void* sol, const void* fixed,
                                     const void* a, const void* b, const void* Z,
                                     const void* weight, int n_edges, int k, float delta,
                                     float two_delta, float delta_sq, const void* cost_it,
                                     const void* lam, int adaptive, void* Xc, void* X_out,
                                     void* state_out, void* stream) {
  if (k < 1 || n_edges < 0) return (int)cudaErrorInvalidValue;
  pose_graph_trial_kernel<<<1, kTrialThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)sol, (const unsigned char*)fixed, (const long long*)a,
      (const long long*)b, (const float*)Z, (const float*)weight, n_edges, k, delta,
      two_delta, delta_sq, (const float*)cost_it, (const float*)lam, adaptive, (float*)Xc,
      (float*)X_out, (float*)state_out);
  return (int)cudaGetLastError();
}
