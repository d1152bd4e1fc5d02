// K1: fused FAST segment test + Shi-Tomasi score + 3x3 NMS for one pyramid
// level.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py detect_score_map (319-397),
// body _detect_core (190-266).
//
// What bounds it on an H100: a 640x480 level is 1.2 MB in and 2.5 MB out,
// well under a microsecond of HBM traffic; the work is ~250 flops and ~40
// shared-memory reads per pixel (gradients, three 9x9 box sums, the
// 16-pixel ring, the 3x3 neighbourhood), so the kernel is bound by
// shared-memory traffic and, at the small pyramid levels, by launch latency
// and too few blocks to fill 132 SMs.
//
// Design: one 32x16 output tile per block. The input tile and a 6-pixel halo
// (NMS 1 + box radius 4 + gradient 1) go into shared memory once, zero-filled
// outside the image like the Pallas kernel; every intermediate (gradients,
// row box sums, score, corner flags) stays in shared memory and only the two
// output maps are written. One kernel serves every level: the whole-image /
// row-tiled split of the Pallas version existed only for the TPU's VMEM.
// Semantics kept: gradients are zero on the outer row and column, box sums
// are zero-padded and separable (row pass, then column pass, adding the +s
// then the -s neighbour), FAST-10 runs only on the 3-pixel interior with
// wrap-around arcs, NMS is >= over the corner score with -inf outside. The
// box radius (4) and the arc (10) are the tracking step's and are fixed here.
// The Pallas kernel's GFTT mode (use_fast_gate=False) is not ported: nothing
// on the tracking step uses it.
// Built with -fmad=false and written in the plain version's operation order,
// so the maps round exactly like detect_score_map_ref.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;                 // output tile width
constexpr int TH = 16;                 // output tile height
constexpr int HALO = 6;
constexpr int R = 4;                   // Shi-Tomasi box radius
constexpr int kArc = 10;               // FAST arc length
constexpr int SW = TW + 2 * HALO;      // image tile (halo 6)
constexpr int SH = TH + 2 * HALO;
constexpr int GW = TW + 10;            // gradients (halo 5)
constexpr int GH = TH + 10;
constexpr int BW = TW + 2;             // score / corners (halo 1)
constexpr int BH = TH + 2;

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void __launch_bounds__(TW * TH)
detect_kernel(const float* __restrict__ img, int h, int w, float thr,
              float* __restrict__ out, float* __restrict__ raw) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_dx[GH][GW];
  __shared__ float s_dy[GH][GW];
  __shared__ float s_hxx[GH][BW];
  __shared__ float s_hyy[GH][BW];
  __shared__ float s_hxy[GH][BW];
  __shared__ float s_score[BH][BW];
  __shared__ float s_cs[BH][BW];
  __shared__ unsigned char s_corner[BH][BW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthr = TW * TH;
  const float NEG_INF = -INFINITY;

  // 1. image tile + halo, zero outside the image
  for (int i = tid; i < SH * SW; i += nthr) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // 2. central-difference gradients (halo 5), zero on the outer row/column
  for (int i = tid; i < GH * GW; i += nthr) {
    const int ly = i / GW, lx = i % GW;
    const int gy = y0 - 5 + ly, gx = x0 - 5 + lx;
    const float right = s_img[ly + 1][lx + 2], left = s_img[ly + 1][lx];
    const float down = s_img[ly + 2][lx + 1], up = s_img[ly][lx + 1];
    s_dx[ly][lx] = (gx >= 1 && gx < w - 1) ? right - left : 0.0f;
    s_dy[ly][lx] = (gy >= 1 && gy < h - 1) ? down - up : 0.0f;
  }
  __syncthreads();

  // 3. row pass of the 9x9 box sums of dx*dx, dy*dy, dx*dy
  for (int i = tid; i < GH * BW; i += nthr) {
    const int ly = i / BW, bx = i % BW;
    const int c = bx + R;
    float axx = s_dx[ly][c] * s_dx[ly][c];
    float ayy = s_dy[ly][c] * s_dy[ly][c];
    float axy = s_dx[ly][c] * s_dy[ly][c];
    for (int s = 1; s <= R; ++s) {
      const float dxp = s_dx[ly][c + s], dyp = s_dy[ly][c + s];
      const float dxm = s_dx[ly][c - s], dym = s_dy[ly][c - s];
      axx = axx + dxp * dxp + dxm * dxm;
      ayy = ayy + dyp * dyp + dym * dym;
      axy = axy + dxp * dyp + dxm * dym;
    }
    s_hxx[ly][bx] = axx;
    s_hyy[ly][bx] = ayy;
    s_hxy[ly][bx] = axy;
  }
  __syncthreads();

  // 4. column pass -> Shi-Tomasi min eigenvalue; FAST segment test
  const float inv = (float)(1.0 / (2.0 * (double)((2 * R + 1) * (2 * R + 1))));
  const unsigned window = (1u << kArc) - 1u;
  for (int i = tid; i < BH * BW; i += nthr) {
    const int by = i / BW, bx = i % BW;
    const int r0 = by + R;
    float sxx = s_hxx[r0][bx], syy = s_hyy[r0][bx], sxy = s_hxy[r0][bx];
    for (int s = 1; s <= R; ++s) {
      sxx = sxx + s_hxx[r0 + s][bx] + s_hxx[r0 - s][bx];
      syy = syy + s_hyy[r0 + s][bx] + s_hyy[r0 - s][bx];
      sxy = sxy + s_hxy[r0 + s][bx] + s_hxy[r0 - s][bx];
    }
    const float dxx = sxx * inv, dyy = syy * inv, dxy = sxy * inv;
    const float tr = dxx + dyy;
    const float diff = dxx - dyy;
    float v = diff * diff + 4.0f * dxy * dxy;
    v = (v < 0.0f) ? 0.0f : v;                  // max(v, 0), NaN kept
    const float score = 0.5f * (tr - sqrtf(v));

    const int gy = y0 - 1 + by, gx = x0 - 1 + bx;
    bool corner = false;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const float center = s_img[by + 5][bx + 5];
      const float hi = center + thr, lo = center - thr;
      unsigned bmask = 0u, dmask = 0u;
      for (int k = 0; k < 16; ++k) {
        const float rk = s_img[by + 5 + kRingDy[k]][bx + 5 + kRingDx[k]];
        if (rk > hi) bmask |= 1u << k;
        if (rk < lo) dmask |= 1u << k;
      }
      const unsigned bext = bmask | (bmask << 16);   // wrap-around arcs
      const unsigned dext = dmask | (dmask << 16);
      for (int s = 0; s < 16; ++s) {
        corner = corner || (((bext >> s) & window) == window)
                        || (((dext >> s) & window) == window);
      }
    }
    s_score[by][bx] = score;
    s_cs[by][bx] = corner ? score : NEG_INF;
    s_corner[by][bx] = corner ? 1 : 0;
  }
  __syncthreads();

  // 5. 3x3 NMS (>= every neighbour) and the two outputs
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx < w && gy < h) {
    const float c = s_cs[ty + 1][tx + 1];
    float nbmax = c;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        const float v = s_cs[ty + dy][tx + dx];
        nbmax = v > nbmax ? v : nbmax;
      }
    const bool keep = s_corner[ty + 1][tx + 1] && c >= nbmax;
    const float score = s_score[ty + 1][tx + 1];
    out[gy * w + gx] = keep ? score : NEG_INF;
    raw[gy * w + gx] = score;
  }
}

}  // namespace

extern "C" int rgbd_detect_score_map(const void* img, int h, int w, float thr,
                                     void* out, void* raw, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  dim3 block(TW, TH);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  detect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, thr, (float*)out, (float*)raw);
  return (int)cudaGetLastError();
}
