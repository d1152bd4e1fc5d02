// Shared by K4 (csrc/gicp.cu) and the Mahalanobis polish of the fused
// RANSAC (csrc/mahal.cu): the damped 6x6 solve by pivoted elimination and
// the left SE(3) exp-compose, on registers. Included inside each file's
// anonymous namespace.

#pragma once

constexpr float kDamping = 1e-6f;   // as _gicp_iteration, _gn_step and refine_mahalanobis

// index of entry (i, j), i <= j, among the 21 upper-triangular entries of H
__host__ __device__ constexpr int tri6(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }
// x = -(H + kDamping I)^-1 b by Gaussian elimination with partial pivoting
// (Hs = 21 upper-triangular entries), as the plain version's LU solve.
// The Pallas kernel's unpivoted Cholesky (_chol6_solve_neg) returns NaN
// when H is indefinite, which real frames produce: the one-pass depth-patch
// covariances cancel in f32 and come out slightly indefinite.
// Every loop unrolls and every index is a constant, so A stays in registers;
// the pivot row is brought up by selects.
__device__ __forceinline__ void solve6_neg(const float (&Hs)[21], const float (&bs)[6],
                                           float (&x)[6]) {
  float A[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = Hs[tri6(i, j)];
      A[j][i] = Hs[tri6(i, j)];
    }
    A[i][i] = A[i][i] + kDamping;
    A[i][6] = -bs[i];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float big = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float v = fabsf(A[r][c]);
      if (v > big) {
        big = v;
        piv = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const bool sw = piv == r;
#pragma unroll
      for (int j = c; j < 7; ++j) {
        const float a = A[c][j], b = A[r][j];
        A[c][j] = sw ? b : a;
        A[r][j] = sw ? a : b;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
#pragma unroll
      for (int j = c; j < 7; ++j) A[r][j] = A[r][j] - f * A[c][j];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - A[i][m] * x[m];
    x[i] = s / A[i][i];
  }
}

// (R, t) <- exp(xi) (R, t), xi = [rho | phi] (geometry/se3.exp convention)
__device__ __forceinline__ void se3_exp_compose(const float (&xi)[6], float (&R)[3][3],
                                                float (&t)[3]) {
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float hsq = (i == j) ? phi[i] * phi[j] - th2 : phi[i] * phi[j];
      const float delta = (i == j) ? 1.0f : 0.0f;
      Re[i][j] = delta + A * hat[i][j] + B * hsq;
      V[i][j] = delta + B * hat[i][j] + C * hsq;
    }
  float Rn[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float te = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rn[i][j] = Re[i][0] * R[0][j] + Re[i][1] * R[1][j] + Re[i][2] * R[2][j];
    tn[i] = Re[i][0] * t[0] + Re[i][1] * t[1] + Re[i][2] * t[2] + te;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
    t[i] = tn[i];
  }
}

