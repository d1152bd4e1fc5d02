// K3: RANSAC hypothesis scorer under the RGB-D Mahalanobis noise model.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py mahal_hypothesis_scores
// (479-526), body _mahal_kernel (405-476).
//
// For hypothesis [R|t] and correspondence i: d = R p1 + t - p2,
// C = R diag(s1) R^T + diag(s2) (six unique entries),
// m^2 = d^T adj(C) d / det(C) clamped at 0; an inlier has m^2 <= th and a
// valid slot. Per hypothesis: inlier count and the sum of m^2 over inliers.
//
// What bounds it on an H100: 256 x 1024 pairs x ~90 flops is 24 MFLOP in
// f32 from 60 KB of inputs, so it is compute- and latency-bound, a few
// microseconds of one wave; the plain PyTorch version instead streams ~25
// (H, N) float intermediates (~25 MB) through HBM.
//
// Design: one block per hypothesis, 256 threads striding over the N
// correspondences, a block reduction for the count (int) and the error sum
// (float). Nothing (H, N) is ever written. Each m^2 is computed in the
// Pallas kernel's operation order, and the library is built with
// -fmad=false, so m^2 rounds exactly as in the plain version and the counts
// agree exactly; only the order of the float sum differs.
//
// Batch: blockIdx.y is the batch entry with its own hypotheses,
// correspondences and validity (the keyframe backend scores the RANSAC
// hypotheses of all its candidate keyframes in one launch). The unbatched
// call is the batch of one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mahal_kernel(const float* __restrict__ T, const float* __restrict__ p1,
             const float* __restrict__ p2, const float* __restrict__ s1,
             const float* __restrict__ s2,
             const unsigned char* __restrict__ valid, int n, float th,
             int* __restrict__ cnt_out, float* __restrict__ err_out) {
  __shared__ int s_cnt[kThreads];
  __shared__ float s_err[kThreads];

  const size_t z = blockIdx.y;
  const size_t hyp = z * gridDim.x + blockIdx.x;
  p1 += z * (size_t)n * 3;
  p2 += z * (size_t)n * 3;
  s1 += z * (size_t)n * 3;
  s2 += z * (size_t)n * 3;
  valid += z * (size_t)n;
  const float* Th = T + hyp * 16;
  const float R0 = Th[0], R1 = Th[1], R2 = Th[2], tx = Th[3];
  const float R3 = Th[4], R4 = Th[5], R5 = Th[6], ty = Th[7];
  const float R6 = Th[8], R7 = Th[9], R8 = Th[10], tz = Th[11];

  int cnt = 0;
  float err = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x1 = p1[3 * i], y1 = p1[3 * i + 1], z1 = p1[3 * i + 2];
    const float x2 = p2[3 * i], y2 = p2[3 * i + 1], z2 = p2[3 * i + 2];
    const float a0 = s1[3 * i], a1 = s1[3 * i + 1], a2 = s1[3 * i + 2];
    const float b0 = s2[3 * i], b1 = s2[3 * i + 1], b2 = s2[3 * i + 2];

    const float d1 = R0 * x1 + R1 * y1 + R2 * z1 + tx - x2;
    const float d2 = R3 * x1 + R4 * y1 + R5 * z1 + ty - y2;
    const float d3 = R6 * x1 + R7 * y1 + R8 * z1 + tz - z2;

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
    float m2 = quad * inv_det;
    m2 = (m2 < 0.0f) ? 0.0f : m2;                // max(m2, 0), NaN kept
    if (m2 <= th && valid[i]) {
      cnt += 1;
      err += m2;
    }
  }
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
  if (threadIdx.x == 0) {
    cnt_out[hyp] = s_cnt[0];
    err_out[hyp] = s_err[0];
  }
}

}  // namespace

extern "C" int rgbd_mahal_hypothesis_scores(const void* T, const void* p1,
                                            const void* p2, const void* s1,
                                            const void* s2, const void* valid,
                                            int batch, int h, int n, float th,
                                            void* cnt, void* err, void* stream) {
  mahal_kernel<<<dim3(h, batch), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)T, (const float*)p1, (const float*)p2, (const float*)s1,
      (const float*)s2, (const unsigned char*)valid, n, th, (int*)cnt,
      (float*)err);
  return (int)cudaGetLastError();
}
