// K1: fused FAST segment test + Shi-Tomasi score + 3x3 NMS, and around it
// the whole keypoint detection in two launches: of the half-sample pyramid
// (best corner per grid cell over all levels, the response gate, the top-N
// cells) and of the x1.2 scale space (per level the best corner per cell,
// the top cells of each level's quota, the gate marking slots valid), with
// subpixel offsets on request.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py detect_score_map (320-397),
// body _detect_core (190-266), and the code XLA fused around it in
// rgbdslam_tpu/ops/fast.py detect_keypoints (152-264: border gate, best per
// cell, merge over levels, top-k, subpixel refinement) and
// detect_keypoints_level (285-357) as frontend/frame.py
// _multiscale_detect_describe (166-207) calls it once a level.
//
// What bounds it on an H100: a 640x480 level is 1.2 MB in, well under a
// microsecond of HBM traffic; the work is ~270 operations and ~40
// shared-memory reads per pixel (gradients, three 9x9 box sums, the 16-pixel
// ring and its arcs, the 3x3 neighbourhood), so the tile computation is
// bound by shared-memory traffic. What bounded the detection as a whole was
// its boundary: a dense kernel wrote two maps a level (4.9 MB a half-sample
// frame, 7.6 MB an x1.2 one) and ~40 small tensor ops a level read them back
// (gate, tile copy, amax, argmax, coordinates, merge or sort, gathers,
// padding), and subpixel refinement read raw maps again: ~160 launches a
// half-sample detection, ~340 an x1.2 one, for what one tile already holds
// in shared memory.
//
// Design. The tile computation is one device function, tile_scores, shared
// by four kernels:
//  * detect_kernel, the dense maps of one level: the TPU kernel's direct
//    counterpart, behind its public entry (kernels.detect_score_map) and the
//    per-level detection of fast.detect_keypoints_level; no main path
//    launches it.
//  * detect_cells_kernel (kernel A), one launch over the tiles of every
//    level (of every 32 levels: a launch's table holds 32, and only an x1.2
//    scale space of more levels needs a second group): a flat block index is
//    mapped to (level, tile) through a table
//    passed by value (LevelTable), which gives each level its image, its
//    cell size in its own pixels, its grid, its first entry in the output and
//    its border frame. The half-sample pyramid: cell_size >> level, the
//    level-0 grid, the border in level-0 coordinates; the x1.2 scale space:
//    cell_size on every level, the level's own grid and border. The FAST
//    threshold is a device scalar, read once per block (the TPU kernel's
//    thr_ref): a threshold that the batched tracker evolves on the device
//    costs no host read. A level's tile is made of whole cells of its cell
//    size c (1 to 32): c * max(1, 32 / c) pixels wide and c * max(1, 16 / c)
//    high (whole_cell_tile), so the reference's 5-pixel SVO grid runs as
//    30 x 15 tiles; where every level's tile is 32 x 16 (c = 1, 2, 4, 8,
//    16, the default configuration) a fixed instantiation keeps the strides
//    constant. A block of 512 threads walks the tile's pixels, up to 1,024
//    (32 x 32). After tile_scores it applies the NMS and the border gate
//    and, for each cell of the tile, finds the maximum and its first index
//    in the cell's row-major order (strict >, so an all -inf cell gives
//    index 0, as argmax does). A cell lies in exactly one tile, so each
//    (level, cell) entry is written by one block, without atomics. Pixels beyond rows*cell x cols*cell belong
//    to no cell. No dense map is written. The masked map holds no NaN (a NaN
//    score never passes the >= of the NMS), so neither do the cell maxima.
//    With subpixel offsets the same thread writes the parabola offsets at
//    the cell's winning pixel from the raw scores still in shared memory
//    (the tile keeps a 1-pixel halo; neighbours clamped into the level).
//    The half-sample merge puts a cell with no corner at pixel (0, 0) of
//    level 0, so the block holding that pixel writes its offsets too.
//    A cell wider than 32 pixels (a low feature budget: cells of 40 or 64
//    at 640x480; on the half-sample pyramid only its upper levels, whose
//    cells halve, on the x1.2 scale space every level) gets a block of its
//    own that walks the cell's 32 x 16 sub-tiles, each scored with its own
//    halo, reduces each to its first maximum by value and then index in the
//    cell's row-major order, and keeps the best over the sub-tiles with the
//    offsets taken at the sub-tile's winner (big_cell). A level too small
//    for one cell has no block and no entry.
//  * detect_select_kernel (kernel B, half-sample), blocks of 16 cells: every
//    block merges the cell maxima of all levels in level order with strict >
//    (the lower level keeps ties; a cell with no corner keeps u = v = 0,
//    level 0), applies score > min_response (else -inf) and keeps the gated
//    scores in shared memory (4 bytes a cell); then a
//    warp ranks one cell as a stable descending sort does (rank = cells with
//    a greater score + cells with an equal score and a lower index; the
//    lanes stride over the scores four a load, without a branch, and add
//    their counts) and, if the rank is below k = min(num_features, n_cells),
//    writes that keypoint slot, moved by its winning level's offsets scaled
//    by 1 << level when asked; block 0 zeroes the padding above k. Ranks are
//    distinct, so every slot has one writer.
//    Counting is n_cells^2 comparisons (1.4 M at 640x480) of ~4 operations:
//    ~25 us of one SM's time, so it is spread over 75 blocks; each
//    pays the merge (three L2 round trips) again. One block of 1,024 threads
//    took 69 us, 10-19 blocks that walked the scores one dependent
//    shared-memory load at a time 12-15 us. Past what a block's shared
//    memory holds (58,112 cells: cells of 1 or 2 pixels at 640x480) every
//    block streams the gated scores through chunks of 8,192 in shared
//    memory, merging each chunk again from the cell maxima in L2, and adds
//    its warps' counts over the chunks; a warp merges its own cell's levels
//    (for its score and, writing, its level). The counts, and so the ranks,
//    are the same integers. At 76,800 cells that is 5.9e9 comparisons a
//    detection.
//    NaN: a NaN maximum never wins the merge (NaN > x is false, in the plain
//    version too), so the cell keeps what the other levels gave it and the
//    ranking never sees a NaN.
//  * detect_rank_kernel (kernel C, x1.2), blocks of 16 cells of one level:
//    the block loads the level's ungated cell maxima, a warp ranks one cell
//    among them by the same count and, below the level's quota, writes slot
//    first_slot + rank in level pixels (with the offsets), valid where the
//    maximum is finite and above the gate. Counting is the sum of the
//    levels' n_l^2, 2.7 M comparisons at 640x480, over 230 blocks. The
//    levels' slots come out in level order; the caller scales each slot to
//    level 0 by its level's f32(1.2^l). Past what shared memory holds
//    (58,112 cells on a level) the maxima stream through chunks as in
//    kernel B.
//
// The whole-image / row-tiled split of the Pallas version existed only for
// the TPU's VMEM. The input tile and a 6-pixel halo (NMS 1 + box radius 4 + gradient 1) go
// into shared memory once, zero-filled outside the image like the Pallas
// kernel; every intermediate (gradients, row box sums, score, corner flags)
// stays in shared memory (dynamic, sized for the largest level's tile: 36 KB
// at 32 x 16 and for the sub-tiles of a wider cell, 61 KB at 32 x 32).
// Semantics kept: gradients are zero on the outer row and column, box sums
// are zero-padded and separable (row pass, then column pass, adding the +s
// then the -s neighbour), FAST-10 runs only on the 3-pixel interior with
// wrap-around arcs, NMS is >= over the corner score with -inf outside. The
// box radius (4) and the arc (10) are the tracking step's and are fixed here.
// GFTT mode (use_fast_gate=False, the Pallas kernel's static flag): every
// pixel of the level is a candidate (no FAST test, no 3-pixel interior), and
// the NMS runs over the dense score with -inf outside the image, as
// _detect_core does (pallas_kernels.py:253-265). Every kernel takes it as a
// flag.
// Kernels B and C compute the final response gate from the device
// threshold: with the FAST gate, (thr * thr) * gate_scale, gate_scale =
// min_response * (1 / cfg threshold)^2 in f32: what XLA compiles the JAX
// package's min_response * (thr / cfg threshold)^2 into
// (frontend/frame.py:103-106); without it, min_response.
// Built with -fmad=false and written in the plain versions' operation order,
// so the maps, the offsets and the keypoints round exactly like
// detect_score_map_ref, detect_keypoints_ref and detect_keypoints_scaled_ref.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;                 // the dense kernel's tile, and kernel A's widest
constexpr int TH = 16;                 // ... and its usual height
constexpr int kTileThreads = TW * TH;  // threads of a tile's block
constexpr int HALO = 6;
constexpr int R = 4;                   // Shi-Tomasi box radius
constexpr int kArc = 10;               // FAST arc length

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Everything a tw x th tile keeps in shared memory, as views into the
// block's dynamic shared memory: the image with a 6-pixel halo (sw wide),
// the gradients with 5 (gw), the row box sums (gw rows of bw), the scores,
// corner scores and corner flags with 1 (bw). A tile's strides are the
// dense kernel's constants where the tile is 32 x 16, so the compiler folds
// them there.
struct Tile {
  float* f;          // the views, end to end
  int tw, th, sw, gw, bw;
  __device__ __forceinline__ float* img() const { return f; }
  __device__ __forceinline__ float* dx() const { return f + (th + 2 * HALO) * sw; }
  __device__ __forceinline__ float* dy() const { return dx() + (th + 10) * gw; }
  __device__ __forceinline__ float* hxx() const { return dy() + (th + 10) * gw; }
  __device__ __forceinline__ float* hyy() const { return hxx() + (th + 10) * bw; }
  __device__ __forceinline__ float* hxy() const { return hyy() + (th + 10) * bw; }
  __device__ __forceinline__ float* score() const { return hxy() + (th + 10) * bw; }
  __device__ __forceinline__ float* cs() const { return score() + (th + 2) * bw; }
  __device__ __forceinline__ unsigned char* corner() const {
    return reinterpret_cast<unsigned char*>(cs() + (th + 2) * bw);
  }
};

__host__ __device__ __forceinline__ int tile_floats(int tw, int th) {
  return (th + 2 * HALO) * (tw + 2 * HALO) + 2 * (th + 10) * (tw + 10)
         + 3 * (th + 10) * (tw + 2) + 2 * (th + 2) * (tw + 2);
}

// Bytes of a tile's views (the corner flags last, rounded up to 16).
__host__ __device__ __forceinline__ int tile_bytes(int tw, int th) {
  return (tile_floats(tw, th) * 4 + (th + 2) * (tw + 2) + 15) & ~15;
}

// The views of a tw x th tile at `base`: one base pointer and the strides,
// each view's offset computed where it is used (constants where tw and th
// are), so no view takes a register of its own.
__device__ __forceinline__ Tile carve_tile(char* base, int tw, int th) {
  Tile t;
  t.f = reinterpret_cast<float*>(base);
  t.tw = tw;
  t.th = th;
  t.sw = tw + 2 * HALO;
  t.gw = tw + 10;
  t.bw = tw + 2;
  return t;
}

// Steps 1-4 for the tw x th tile at (x0, y0) of a level of h x w pixels:
// the image and its halo, the gradients, the box sums, then at every pixel
// of the tile and its 1-pixel halo the Shi-Tomasi score, the FAST flag and
// the corner score (-inf where no corner). Called by all the block's
// kTileThreads threads; ends with a barrier.
__device__ __forceinline__ void tile_scores(const float* __restrict__ img, int h, int w,
                                            float thr, bool fast_gate, int x0, int y0,
                                            const Tile& s) {
  const int tid = threadIdx.x;
  const int nthr = kTileThreads;
  const float NEG_INF = -INFINITY;
  const int SW = s.sw, SH = s.th + 2 * HALO;
  const int GW = s.gw, GH = s.th + 10;
  const int BW = s.bw, BH = s.th + 2;

  // 1. image tile + halo, zero outside the image
  for (int i = tid; i < SH * SW; i += nthr) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s.img()[ly * SW + lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // 2. central-difference gradients (halo 5), zero on the outer row/column
  for (int i = tid; i < GH * GW; i += nthr) {
    const int ly = i / GW, lx = i % GW;
    const int gy = y0 - 5 + ly, gx = x0 - 5 + lx;
    const float right = s.img()[(ly + 1) * SW + lx + 2], left = s.img()[(ly + 1) * SW + lx];
    const float down = s.img()[(ly + 2) * SW + lx + 1], up = s.img()[ly * SW + lx + 1];
    s.dx()[ly * GW + lx] = (gx >= 1 && gx < w - 1) ? right - left : 0.0f;
    s.dy()[ly * GW + lx] = (gy >= 1 && gy < h - 1) ? down - up : 0.0f;
  }
  __syncthreads();

  // 3. row pass of the 9x9 box sums of dx*dx, dy*dy, dx*dy
  for (int i = tid; i < GH * BW; i += nthr) {
    const int ly = i / BW, bx = i % BW;
    const float* dxr = s.dx() + ly * GW + bx + R;
    const float* dyr = s.dy() + ly * GW + bx + R;
    float axx = dxr[0] * dxr[0];
    float ayy = dyr[0] * dyr[0];
    float axy = dxr[0] * dyr[0];
    for (int k = 1; k <= R; ++k) {
      const float dxp = dxr[k], dyp = dyr[k];
      const float dxm = dxr[-k], dym = dyr[-k];
      axx = axx + dxp * dxp + dxm * dxm;
      ayy = ayy + dyp * dyp + dym * dym;
      axy = axy + dxp * dyp + dxm * dym;
    }
    s.hxx()[ly * BW + bx] = axx;
    s.hyy()[ly * BW + bx] = ayy;
    s.hxy()[ly * BW + bx] = axy;
  }
  __syncthreads();

  // 4. column pass -> Shi-Tomasi min eigenvalue; FAST segment test
  const float inv = (float)(1.0 / (2.0 * (double)((2 * R + 1) * (2 * R + 1))));
  const unsigned window = (1u << kArc) - 1u;
  for (int i = tid; i < BH * BW; i += nthr) {
    const int by = i / BW, bx = i % BW;
    const int c0 = (by + R) * BW + bx;
    float sxx = s.hxx()[c0], syy = s.hyy()[c0], sxy = s.hxy()[c0];
    for (int k = 1; k <= R; ++k) {
      sxx = sxx + s.hxx()[c0 + k * BW] + s.hxx()[c0 - k * BW];
      syy = syy + s.hyy()[c0 + k * BW] + s.hyy()[c0 - k * BW];
      sxy = sxy + s.hxy()[c0 + k * BW] + s.hxy()[c0 - k * BW];
    }
    const float dxx = sxx * inv, dyy = syy * inv, dxy = sxy * inv;
    const float tr = dxx + dyy;
    const float diff = dxx - dyy;
    float v = diff * diff + 4.0f * dxy * dxy;
    v = (v < 0.0f) ? 0.0f : v;                  // max(v, 0), NaN kept
    const float score = 0.5f * (tr - sqrtf(v));

    const int gy = y0 - 1 + by, gx = x0 - 1 + bx;
    // GFTT: every pixel of the image is a candidate, none outside it
    bool corner = !fast_gate && gy >= 0 && gy < h && gx >= 0 && gx < w;
    if (fast_gate && gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const float* ctr = s.img() + (by + 5) * SW + bx + 5;
      const float center = ctr[0];
      const float hi = center + thr, lo = center - thr;
      unsigned bmask = 0u, dmask = 0u;
      for (int k = 0; k < 16; ++k) {
        const float rk = ctr[kRingDy[k] * SW + kRingDx[k]];
        if (rk > hi) bmask |= 1u << k;
        if (rk < lo) dmask |= 1u << k;
      }
      const unsigned bext = bmask | (bmask << 16);   // wrap-around arcs
      const unsigned dext = dmask | (dmask << 16);
      for (int k = 0; k < 16; ++k) {
        corner = corner || (((bext >> k) & window) == window)
                        || (((dext >> k) & window) == window);
      }
    }
    s.score()[by * BW + bx] = score;
    s.cs()[by * BW + bx] = corner ? score : NEG_INF;
    s.corner()[by * BW + bx] = corner ? 1 : 0;
  }
  __syncthreads();
}

// Step 5 at pixel (tx, ty) of the tile, inside the level: the masked score
// (the score where the pixel is a corner that is >= every neighbour's
// corner score, 3x3 NMS, else -inf).
__device__ __forceinline__ float tile_masked(const Tile& s, int tx, int ty) {
  const int BW = s.bw;
  const float* cs = s.cs() + ty * BW + tx;        // the 3x3 window's top left
  const float c = cs[BW + 1];
  float nbmax = c;
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      const float v = cs[dy * BW + dx];
      nbmax = v > nbmax ? v : nbmax;
    }
  const bool keep = s.corner()[(ty + 1) * BW + tx + 1] && c >= nbmax;
  return keep ? s.score()[(ty + 1) * BW + tx + 1] : -INFINITY;
}

// The dense (masked, raw) maps of one level; the threshold from device memory.
// For a pixel outside the image nothing is written. Four blocks an SM (32
// registers a thread), as the 32x16 tile's shared memory allows.
__global__ void __launch_bounds__(kTileThreads, 4)
detect_kernel(const float* __restrict__ img, int h, int w,
              const float* __restrict__ thr_ptr, int fast_gate,
              float* __restrict__ out, float* __restrict__ raw) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_thr;
  const Tile s = carve_tile(reinterpret_cast<char*>(s_dyn), TW, TH);
  if (threadIdx.x == 0) s_thr = *thr_ptr;
  __syncthreads();
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  tile_scores(img, h, w, s_thr, fast_gate != 0, x0, y0, s);
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx < w && gy < h) {
    out[gy * w + gx] = tile_masked(s, tx, ty);
    raw[gy * w + gx] = s.score()[(ty + 1) * s.bw + tx + 1];
  }
}

// ---------------------------------------------------------------------------
// kernel A: best corner per grid cell, every level in one launch
// ---------------------------------------------------------------------------

// Levels a launch's table holds. A detection with more levels (only the
// x1.2 scale space can have them: the half-sample pyramid stops at the level
// whose cell has no pixel) runs its kernel A and C launches over groups of
// kTableLevels levels; kernel B reads no table.
constexpr int kTableLevels = 32;

// Level l: an h x w image whose cells of cell x cell pixels form a rows x cols
// grid, written at entries first_cell[l] .. first_cell[l + 1] - 1 by kernel A's
// blocks first_block[l] .. first_block[l + 1] - 1, each a tw x th tile of
// whole cells (tiles_x tiles a row; see whole_cell_tile), or, for a cell
// wider than TW pixels, one block a cell (tiles_x = cols) that walks the
// cell's TW x TH sub-tiles.
// Border gate: pixel (x, y) takes part iff (x << bshift, y << bshift) lies at
// least min_border inside a bh x bw frame. The half-sample pyramid: cell =
// cell_size >> l, the level-0 grid, bshift = l and the level-0 frame; the x1.2
// scale space: cell = cell_size, the level's own grid, bshift = 0 and its own
// frame. Kernel C ranks level l's cells into slots first_slot[l] ..
// first_slot[l] + quota[l] - 1 with blocks first_rank_block[l] .. , and
// writes base_level + l as their level. Entries are counted from the
// pointers the launch is given (a group's first level, first cell).
struct LevelTable {
  const float* img[kTableLevels];
  int h[kTableLevels];
  int w[kTableLevels];
  int cell[kTableLevels];
  int rows[kTableLevels];
  int cols[kTableLevels];
  int tiles_x[kTableLevels];
  int tw[kTableLevels];
  int th[kTableLevels];
  int bshift[kTableLevels];
  int bh[kTableLevels];
  int bw[kTableLevels];
  int quota[kTableLevels];
  int first_slot[kTableLevels];
  int first_cell[kTableLevels + 1];
  int first_block[kTableLevels + 1];
  int first_rank_block[kTableLevels + 1];
  int n_levels;
  int base_level;
  int zero_entry;  // >= 0: also write the offsets of pixel (0, 0) of level 0 at this entry
};

// The level whose range of `first` holds block b (levels without blocks are
// passed over).
__device__ __forceinline__ int level_of(const int* first, int n_levels, int b) {
  int lvl = 0;
  while (lvl + 1 < n_levels && b >= first[lvl + 1]) ++lvl;
  return lvl;
}

// 1-D quadratic-peak offset in [-0.5, 0.5] from three samples, in the plain
// version's operation order (fast._parabola_offset); a NaN passes through.
__device__ __forceinline__ float parabola_offset(float sm, float sc, float sp) {
  const float denom = sm + sp - 2.0f * sc;
  const float off = fabsf(denom) > 1e-12f ? 0.5f * (sm - sp) / denom : 0.0f;
  return off < -0.5f ? -0.5f : (off > 0.5f ? 0.5f : off);
}

// (ox, oy) at pixel (px, py) of an h x w level from the raw scores of the
// tile at (x0, y0) (1-pixel halo), neighbours clamped into the level.
__device__ __forceinline__ float2 tile_offsets(const Tile& s, int px, int py, int h,
                                               int w, int x0, int y0) {
  const int um = px - 1 < 0 ? 0 : px - 1, up = px + 1 > w - 1 ? w - 1 : px + 1;
  const int vm = py - 1 < 0 ? 0 : py - 1, vp = py + 1 > h - 1 ? h - 1 : py + 1;
  const int bx = px - x0 + 1, by = py - y0 + 1;
  const float* row = s.score() + by * s.bw;
  const float c = row[bx];
  return make_float2(parabola_offset(row[um - x0 + 1], c, row[up - x0 + 1]),
                     parabola_offset(s.score()[(vm - y0 + 1) * s.bw + bx], c,
                                     s.score()[(vp - y0 + 1) * s.bw + bx]));
}

// A level's tile for cells of c pixels: whole cells, c * max(1, 32 / c)
// wide and c * max(1, 16 / c) high: 32 x 16 for c = 1, 2, 4, 8, 16 (the
// fixed instantiation), 30 x 15 for 3 and 5, 30 x 12 for 6, 30 x 10 for 10,
// 24 x 12 for 12, up to 32 x 32 for 32. A wider cell is walked in sub-tiles
// of 32 x 16 (big_cell).
__host__ __device__ __forceinline__ int2 whole_cell_tile(int c) {
  if (c > TW) return make_int2(TW, TH);
  const int nx = TW / c, ny = TH / c;
  return make_int2(c * (nx > 1 ? nx : 1), c * (ny > 1 ? ny : 1));
}

// Bytes of kernel A's dynamic shared memory for a tw x th tile: the tile's
// views, then its gated scores and the row stage's maxima and indices
// (at most one a pixel each).
__host__ __device__ __forceinline__ int cells_bytes(int tw, int th) {
  return tile_bytes(tw, th) + 3 * tw * th * 4;
}

// (v, i) beats (bv, bi) as the first maximum in row-major order does: a
// greater value, or an equal one at a lower index. The masked map holds no
// NaN, so every value compares.
__device__ __forceinline__ bool first_max_beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Kernel A for one cell wider than a tile (c > TW): the block walks the
// cell's ceil(c / TW) x ceil(c / TH) sub-tiles of TW x TH pixels, each
// scored by tile_scores with its own halo; a thread takes one pixel of the
// sub-tile, the block reduces the sub-tile to its first maximum (value,
// index in the cell's row-major order) and thread 0 keeps the better of it
// and the cell's best so far, with the parabola offsets at the sub-tile's
// winner taken while its raw scores are in shared memory. The index decides
// ties, so the order of the sub-tiles does not matter: the result is the
// plain version's argmax (an all -inf cell: index 0, at the cell's first
// pixel, which the first sub-tile holds). s_red: 2 * kTileThreads / 32 words.
__device__ __forceinline__ void big_cell(const LevelTable& tab, int lvl, int cell_idx,
                                         float thr, bool fast_gate, int min_border,
                                         const Tile& s, float* s_red,
                                         float* __restrict__ cell_max,
                                         int* __restrict__ cell_arg,
                                         float2* __restrict__ cell_off) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tab.cell[lvl], cols = tab.cols[lvl];
  const int h = tab.h[lvl], w = tab.w[lvl], bs = tab.bshift[lvl];
  const int cx = cell_idx % cols, cy = cell_idx / cols;
  const int X0 = cx * c, Y0 = cy * c;             // the cell's first pixel
  int* s_redi = reinterpret_cast<int*>(s_red + kTileThreads / 32);
  float best = -INFINITY;                         // thread 0's running winner
  int barg = 0x7fffffff;
  float2 boff = make_float2(0.0f, 0.0f);
  for (int y0 = Y0; y0 < Y0 + c; y0 += TH)
    for (int x0 = X0; x0 < X0 + c; x0 += TW) {
      tile_scores(tab.img[lvl], h, w, thr, fast_gate, x0, y0, s);
      const int tx = tid % TW, ty = tid / TW;
      const int lx = x0 - X0 + tx, ly = y0 - Y0 + ty;
      float v = -INFINITY;
      int idx = 0x7fffffff;
      if (lx < c && ly < c) {                     // inside the cell, so inside the level
        const int X = (x0 + tx) << bs, Y = (y0 + ty) << bs;
        const bool inb = X >= min_border && X < tab.bw[lvl] - min_border
                      && Y >= min_border && Y < tab.bh[lvl] - min_border;
        v = inb ? tile_masked(s, tx, ty) : -INFINITY;
        idx = ly * c + lx;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, o);
        const int oi = __shfl_down_sync(0xffffffffu, idx, o);
        if (first_max_beats(ov, oi, v, idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (lane == 0) {
        s_red[warp] = v;
        s_redi[warp] = idx;
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < kTileThreads / 32; ++k)
          if (first_max_beats(s_red[k], s_redi[k], v, idx)) {
            v = s_red[k];
            idx = s_redi[k];
          }
        if (first_max_beats(v, idx, best, barg)) {
          best = v;
          barg = idx;
          if (cell_off != nullptr)
            boff = tile_offsets(s, X0 + idx % c, Y0 + idx / c, h, w, x0, y0);
        }
        // the half-sample merge's pixel (0, 0) of level 0 lies in the
        // first sub-tile of cell 0
        if (cell_off != nullptr && tab.zero_entry >= 0 && lvl == 0 && cell_idx == 0 &&
            x0 == 0 && y0 == 0)
          cell_off[tab.zero_entry] = tile_offsets(s, 0, 0, h, w, 0, 0);
      }
      __syncthreads();                            // before the next sub-tile's scores
    }
  if (tid == 0) {
    const int e = tab.first_cell[lvl] + cell_idx;
    cell_max[e] = best;
    cell_arg[e] = barg;
    if (cell_off != nullptr) cell_off[e] = boff;
  }
}

// kFixed: every level's tile is 32 x 16 (cells of 1, 2, 4, 8 or 16 pixels),
// with the strides as constants, four blocks an SM; else each level's tile
// from the table, three blocks an SM (a 32 x 32 tile takes 61 KB). The
// table's strides at the default cells cost a quarter more device time on
// an H100 (tools/kernel_device_us.py; PERF.md section 6), hence the two.
template <bool kFixed>
__global__ void __launch_bounds__(kTileThreads, kFixed ? 4 : 3)
detect_cells_kernel(LevelTable tab, const float* __restrict__ thr_ptr, int fast_gate,
                    int min_border, float* __restrict__ cell_max, int* __restrict__ cell_arg,
                    float2* __restrict__ cell_off) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_thr;

  if (threadIdx.x == 0) s_thr = *thr_ptr;
  __syncthreads();
  const float thr = s_thr;

  const int lvl = level_of(tab.first_block, tab.n_levels, blockIdx.x);
  const int tw = kFixed ? TW : tab.tw[lvl];
  const int th = kFixed ? TH : tab.th[lvl];
  const int tile = blockIdx.x - tab.first_block[lvl];
  if (!kFixed && tab.cell[lvl] > TW) {            // a block a cell, over its sub-tiles
    char* base = reinterpret_cast<char*>(s_dyn);
    big_cell(tab, lvl, tile, thr, fast_gate != 0, min_border, carve_tile(base, TW, TH),
             reinterpret_cast<float*>(base + tile_bytes(TW, TH)), cell_max, cell_arg,
             cell_off);
    return;
  }
  const int x0 = (tile % tab.tiles_x[lvl]) * tw;
  const int y0 = (tile / tab.tiles_x[lvl]) * th;
  const int h = tab.h[lvl], w = tab.w[lvl];
  const int cell_l = tab.cell[lvl];

  char* base = reinterpret_cast<char*>(s_dyn);
  const Tile s = carve_tile(base, tw, th);
  float* s_out = reinterpret_cast<float*>(base + tile_bytes(tw, th));   // gated scores
  float* s_rmax = s_out + tw * th;     // [row][cell column]: best of the cell's row
  int* s_rarg = reinterpret_cast<int*>(s_rmax + tw * th);

  tile_scores(tab.img[lvl], h, w, thr, fast_gate != 0, x0, y0, s);

  // NMS and the border gate in the level's frame, pixel by pixel
  const int tid = threadIdx.x;
  const int bs = tab.bshift[lvl];
  for (int p = tid; p < tw * th; p += kTileThreads) {
    const int tx = p % tw, ty = p / tw;
    const int X = (x0 + tx) << bs, Y = (y0 + ty) << bs;
    const bool inb = X >= min_border && X < tab.bw[lvl] - min_border
                  && Y >= min_border && Y < tab.bh[lvl] - min_border;
    const bool inside = x0 + tx < w && y0 + ty < h;
    s_out[p] = (inb && inside) ? tile_masked(s, tx, ty) : -INFINITY;
  }
  __syncthreads();

  // best of each cell's rows, then of each cell: strict >, scanning in
  // row-major order, keeps the first maximum
  const int segs = tw / cell_l;
  if (tid < th * segs) {
    const int row = tid / segs, seg = tid % segs;
    const float* px = s_out + row * tw + seg * cell_l;
    float best = px[0];
    int arg = 0;
    for (int k = 1; k < cell_l; ++k) {
      const float v = px[k];
      if (v > best) {
        best = v;
        arg = k;
      }
    }
    s_rmax[tid] = best;
    s_rarg[tid] = arg;
  }
  __syncthreads();
  if (tid < (th / cell_l) * segs) {
    const int cyl = tid / segs, cxl = tid % segs;
    const int r0 = cyl * cell_l * segs + cxl;   // the cell's first row, its column
    float best = s_rmax[r0];
    int arg = s_rarg[r0];
    for (int j = 1; j < cell_l; ++j) {
      const float v = s_rmax[r0 + j * segs];
      if (v > best) {
        best = v;
        arg = j * cell_l + s_rarg[r0 + j * segs];
      }
    }
    const int cy = y0 / cell_l + cyl, cx = x0 / cell_l + cxl;
    if (cy < tab.rows[lvl] && cx < tab.cols[lvl]) {
      const int idx = tab.first_cell[lvl] + cy * tab.cols[lvl] + cx;
      cell_max[idx] = best;
      cell_arg[idx] = arg;
      // the parabola offsets at the winning pixel (the cell's first pixel
      // for a cell with no corner), on the raw map still in shared memory
      if (cell_off != nullptr)
        cell_off[idx] = tile_offsets(s, cx * cell_l + arg % cell_l, cy * cell_l + arg / cell_l,
                                     h, w, x0, y0);
    }
  }
  // the half-sample merge puts a cell with no corner on any level at pixel
  // (0, 0) of level 0: the block holding that pixel writes its offsets too
  if (cell_off != nullptr && tab.zero_entry >= 0 && lvl == 0 && tile == 0 && tid == 0)
    cell_off[tab.zero_entry] = tile_offsets(s, 0, 0, h, w, 0, 0);
}

// ---------------------------------------------------------------------------
// kernel B: merge the levels, gate, rank, write the keypoints
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelCells = kSelThreads / 32;           // cells a block ranks: a warp each
constexpr int kNoCorner = 255;
// Shared memory a block may take on sm_90 (227 KB): kernels B and C stage
// every cell's score of a level at once where it fits (up to 58,112 cells),
// else they stream the scores through chunks of kChunk cells, which every
// block reads again from L2.
constexpr int kMaxSmem = 232448;
constexpr int kChunk = 8192;

// The cells kernels B and C stage at once for a level of n cells.
int stage_chunk(int n) {
  const int n_pad = (n + 31) & ~31;
  return n_pad * (int)sizeof(float) <= kMaxSmem ? (n_pad > 32 ? n_pad : 32) : kChunk;
}

// The rank of score si at index i among the n_pad scores in shared memory
// (padded with -inf to a multiple of 32) as a stable descending sort places
// it: the scores greater, plus the equal ones at a lower index. Called by
// a whole warp; every lane returns the rank. The lanes stride over the
// scores four a load, without a branch (the -inf padding lies above every
// index and counts for nobody). For a chunk, i is counted from the chunk's
// first cell (negative where cell i comes before it).
__device__ __forceinline__ int stable_rank(const float* s_scores, int n_pad, float si, int i) {
  const float4* scores = reinterpret_cast<const float4*>(s_scores);
  const int lane = threadIdx.x & 31;
  int rank = 0;
#pragma unroll 2
  for (int q = lane; q < n_pad / 4; q += 32) {
    const float4 v = scores[q];
    const int j = 4 * q;
    rank += (int)(v.x > si) + ((int)(v.x == si) & (int)(j < i));
    rank += (int)(v.y > si) + ((int)(v.y == si) & (int)(j + 1 < i));
    rank += (int)(v.z > si) + ((int)(v.z == si) & (int)(j + 2 < i));
    rank += (int)(v.w > si) + ((int)(v.w == si) & (int)(j + 3 < i));
  }
  return __reduce_add_sync(0xffffffffu, rank);
}

// The final response gate: scaled with the device threshold under the FAST
// gate, else min_response.
__device__ __forceinline__ float final_gate(const float* thr_ptr, int scale_gate,
                                            float gate_scale, float min_response) {
  if (!scale_gate) return min_response;
  const float t = *thr_ptr;
  return (t * t) * gate_scale;
}

// Cell i's best over the levels in level order, strict > (the lower level
// keeps ties, NaN never wins); level = kNoCorner where no level has a
// finite-or-better maximum.
__device__ __forceinline__ float merged_cell(const float* __restrict__ cell_max, int n_levels,
                                             int n_cells, int i, int& level) {
  float best = -INFINITY;
  level = kNoCorner;
  for (int l = 0; l < n_levels; ++l) {
    const float m = cell_max[l * n_cells + i];
    if (m > best) {
      best = m;
      level = l;
    }
  }
  return best;
}

// chunk: the cells a block stages at once (stage_chunk).
__global__ void __launch_bounds__(kSelThreads)
detect_select_kernel(const float* __restrict__ cell_max, const int* __restrict__ cell_arg,
                     const float2* __restrict__ cell_off, int n_levels, int n_cells,
                     int grid_cols, int cell_size, const float* __restrict__ thr_ptr,
                     int scale_gate, float gate_scale, float min_response_cfg,
                     int num_features, int chunk, float* __restrict__ uv,
                     int* __restrict__ level_out, float* __restrict__ score_out,
                     unsigned char* __restrict__ valid_out) {
  // gated merged score per cell of the chunk, padded with -inf to a multiple
  // of 32 cells
  extern __shared__ float4 s_mem[];
  float* s_sel = reinterpret_cast<float*>(s_mem);
  const int n_pad = (n_cells + 31) & ~31;
  const int tid = threadIdx.x;
  const int k = num_features < n_cells ? num_features : n_cells;
  const float min_response = final_gate(thr_ptr, scale_gate, gate_scale, min_response_cfg);

  if (blockIdx.x == 0)
    for (int r = k + tid; r < num_features; r += kSelThreads) {   // padding slots
      uv[2 * r] = 0.0f;
      uv[2 * r + 1] = 0.0f;
      level_out[r] = 0;
      score_out[r] = 0.0f;
      valid_out[r] = 0;
    }

  // a warp ranks one cell among all cells: its merged, gated score first
  const int i = blockIdx.x * kSelCells + (tid >> 5);
  const bool mine = i < n_cells;
  int level = kNoCorner;
  float si = -INFINITY;
  if (mine) {
    const float best = merged_cell(cell_max, n_levels, n_cells, i, level);
    si = best > min_response ? best : -INFINITY;
  }
  int rank = 0;
  // every block merges and gates all cells (a few thousand L2 reads, a cell's
  // levels in order), chunk by chunk, and counts for its own 16
  for (int c0 = 0; c0 < n_pad; c0 += chunk) {
    const int len = n_pad - c0 < chunk ? n_pad - c0 : chunk;
    if (c0 > 0) __syncthreads();                 // the last chunk's counts are done
    for (int j = tid; j < len; j += kSelThreads) {
      int lv;
      const float best = c0 + j < n_cells ? merged_cell(cell_max, n_levels, n_cells, c0 + j, lv)
                                          : -INFINITY;
      s_sel[j] = best > min_response ? best : -INFINITY;
    }
    __syncthreads();
    if (mine) rank += stable_rank(s_sel, len, si, i - c0);
  }
  if (!mine || (tid & 31) != 0 || rank >= k) return;

  // the winner of cell i, in level-0 pixel coordinates; a cell with no
  // corner keeps u = v = 0 and level 0. With offsets, the winner moves by
  // its level's, scaled to level 0 (the no-corner cell by those of pixel
  // (0, 0) of level 0, kernel A's extra entry).
  int u = 0, v = 0;
  float2 off = make_float2(0.0f, 0.0f);
  if (level == kNoCorner) {
    level = 0;
    if (cell_off != nullptr) off = cell_off[n_levels * n_cells];
  } else {
    const int cell_l = cell_size >> level;
    const int arg = cell_arg[level * n_cells + i];
    u = ((i % grid_cols) * cell_l + arg % cell_l) << level;
    v = ((i / grid_cols) * cell_l + arg / cell_l) << level;
    if (cell_off != nullptr) off = cell_off[level * n_cells + i];
  }
  const bool ok = si > min_response;         // -inf where the cell failed the gate
  float fu = (float)u, fv = (float)v;
  if (cell_off != nullptr) {
    const float scale = (float)(1 << level);
    fu = fu + off.x * scale;
    fv = fv + off.y * scale;
  }
  uv[2 * rank] = fu;
  uv[2 * rank + 1] = fv;
  level_out[rank] = level;
  score_out[rank] = ok ? si : 0.0f;
  valid_out[rank] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// kernel C: the per-level selection of the x1.2 scale space
// ---------------------------------------------------------------------------

// Blocks of 16 cells of one level: the block stages the level's cell maxima
// (ungated, padded with -inf; every cell at once, or chunks of `chunk`
// cells), a warp ranks one cell among them as a stable descending sort does
// and, below the level's quota, writes slot first_slot + rank: uv in level
// pixels (plus the offsets), valid = finite and above the gate, score =
// valid ? maximum : 0, level base_level + l. The level's first block zeroes
// its slots from n_l to the quota (invalid, that level). An -inf cell ranks
// by its index and keeps its cell's first pixel.
__global__ void __launch_bounds__(kSelThreads)
detect_rank_kernel(LevelTable tab, const float* __restrict__ cell_max,
                   const int* __restrict__ cell_arg, const float2* __restrict__ cell_off,
                   const float* __restrict__ thr_ptr, int scale_gate, float gate_scale,
                   float min_response_cfg, int chunk, float* __restrict__ uv,
                   int* __restrict__ level_out, float* __restrict__ score_out,
                   unsigned char* __restrict__ valid_out) {
  extern __shared__ float4 s_mem[];
  float* s_max = reinterpret_cast<float*>(s_mem);
  const int tid = threadIdx.x;
  const int lvl = level_of(tab.first_rank_block, tab.n_levels, blockIdx.x);
  const int out_level = tab.base_level + lvl;
  const int block = blockIdx.x - tab.first_rank_block[lvl];
  const int n = tab.rows[lvl] * tab.cols[lvl];
  const int n_pad = (n + 31) & ~31;
  const int quota = tab.quota[lvl];
  const int slot0 = tab.first_slot[lvl];
  const int first = tab.first_cell[lvl];
  const float min_response = final_gate(thr_ptr, scale_gate, gate_scale, min_response_cfg);

  if (block == 0)
    for (int r = n + tid; r < quota; r += kSelThreads) {        // padding slots
      const int slot = slot0 + r;
      uv[2 * slot] = 0.0f;
      uv[2 * slot + 1] = 0.0f;
      level_out[slot] = out_level;
      score_out[slot] = 0.0f;
      valid_out[slot] = 0;
    }

  const int i = block * kSelCells + (tid >> 5);
  const bool mine = i < n;
  const float si = mine ? cell_max[first + i] : -INFINITY;
  int rank = 0;
  for (int c0 = 0; c0 < n_pad; c0 += chunk) {
    const int len = n_pad - c0 < chunk ? n_pad - c0 : chunk;
    if (c0 > 0) __syncthreads();                 // the last chunk's counts are done
    for (int j = tid; j < len; j += kSelThreads)
      s_max[j] = c0 + j < n ? cell_max[first + c0 + j] : -INFINITY;
    __syncthreads();
    if (mine) rank += stable_rank(s_max, len, si, i - c0);
  }
  if (!mine || (tid & 31) != 0 || rank >= quota) return;

  const int cell = tab.cell[lvl], cols = tab.cols[lvl];
  const int arg = cell_arg[first + i];
  float fu = (float)((i % cols) * cell + arg % cell);
  float fv = (float)((i / cols) * cell + arg / cell);
  if (cell_off != nullptr) {
    const float2 off = cell_off[first + i];
    fu = fu + off.x;
    fv = fv + off.y;
  }
  const bool ok = isfinite(si) && si > min_response;
  const int slot = slot0 + rank;
  uv[2 * slot] = fu;
  uv[2 * slot + 1] = fv;
  level_out[slot] = out_level;
  score_out[slot] = ok ? si : 0.0f;
  valid_out[slot] = ok ? 1 : 0;
}

// Kernel A's blocks, tiles and the table's entries from each level's cell
// and grid; false where a level's cell is below 1 pixel or its grid does not
// fit its image. `fixed` says whether every tile is 32 x 16 of whole cells
// and `bytes` gives the dynamic shared memory of the largest tile.
bool plan_tiles(LevelTable& tab, bool& fixed, int& bytes) {
  int blocks = 0, cells = 0;
  fixed = true;
  bytes = 0;
  for (int l = 0; l < tab.n_levels; ++l) {
    const int c = tab.cell[l];
    const bool empty = tab.rows[l] == 0 || tab.cols[l] == 0;
    if (!empty && (c < 1 || tab.h[l] < tab.rows[l] * c || tab.w[l] < tab.cols[l] * c))
      return false;
    const bool big = c > TW;                     // a block a cell
    const int2 t = empty ? make_int2(TW, TH) : whole_cell_tile(c);
    tab.tw[l] = t.x;
    tab.th[l] = t.y;
    if (!empty) {
      fixed = fixed && !big && t.x == TW && t.y == TH;
      const int b = cells_bytes(t.x, t.y);
      bytes = b > bytes ? b : bytes;
    }
    tab.tiles_x[l] = empty ? 0 : (big ? tab.cols[l] : (tab.cols[l] * c + t.x - 1) / t.x);
    tab.first_block[l] = blocks;
    tab.first_cell[l] = cells;
    blocks += empty ? 0 : (big ? tab.rows[l] * tab.cols[l]
                               : tab.tiles_x[l] * ((tab.rows[l] * c + t.y - 1) / t.y));
    cells += tab.rows[l] * tab.cols[l];
  }
  for (int l = tab.n_levels; l <= kTableLevels; ++l) {
    tab.first_block[l] = blocks;
    tab.first_cell[l] = cells;
  }
  for (int l = tab.n_levels; l < kTableLevels; ++l) {
    tab.img[l] = nullptr;
    tab.h[l] = tab.w[l] = tab.cell[l] = tab.rows[l] = tab.cols[l] = tab.tiles_x[l] = 0;
    tab.tw[l] = tab.th[l] = 0;
    tab.bshift[l] = tab.bh[l] = tab.bw[l] = tab.quota[l] = tab.first_slot[l] = 0;
  }
  if (fixed) bytes = cells_bytes(TW, TH);
  return true;
}

// Dynamic shared memory of a block beyond 48 KB needs the attribute.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Kernel A over the table's blocks: the fixed instantiation where every tile
// is 32 x 16, else the one that reads each level's tile from the table.
cudaError_t launch_cells(const LevelTable& tab, bool fixed, int bytes, const float* thr,
                         int fast_gate, int min_border, float* cell_max, int* cell_arg,
                         float2* off, cudaStream_t st) {
  const int blocks = tab.first_block[kTableLevels];
  if (blocks == 0) return cudaSuccess;
  if (fixed) {
    detect_cells_kernel<true><<<blocks, kTileThreads, bytes, st>>>(
        tab, thr, fast_gate, min_border, cell_max, cell_arg, off);
  } else {
    const cudaError_t e = allow_smem(detect_cells_kernel<false>, bytes);
    if (e != cudaSuccess) return e;
    detect_cells_kernel<false><<<blocks, kTileThreads, bytes, st>>>(
        tab, thr, fast_gate, min_border, cell_max, cell_arg, off);
  }
  return cudaGetLastError();
}

}  // namespace

// thr: the FAST threshold, one float in device memory (unread in GFTT mode).
extern "C" int rgbd_detect_score_map(const void* img, int h, int w, const void* thr,
                                     int fast_gate, void* out, void* raw, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  detect_kernel<<<grid, kTileThreads, tile_bytes(TW, TH), (cudaStream_t)stream>>>(
      (const float*)img, h, w, (const float*)thr, fast_gate, (float*)out, (float*)raw);
  return (int)cudaGetLastError();
}

// The whole detection of the half-sample pyramid on one stream: kernel A over
// the tiles that cover the cells of each level (one launch a group of
// kTableLevels levels), then kernel B. thr: the FAST threshold, one float in
// device memory; fast_gate 0 for the GFTT mode; scale_gate 1 to gate by
// thr^2 * gate_scale on the device instead of min_response. imgs, hs, ws:
// host arrays of n_levels entries, level l of hs[l] x ws[l] pixels holding at
// least grid_rows x grid_cols cells of (cell_size >> l)^2 pixels. cell_max,
// cell_arg: (n_levels, grid_rows * grid_cols); cell_off (n_levels * grid_rows
// * grid_cols + 1, 2) f32 with `subpixel`, else unused (null): the winners
// then move by their level's parabola offsets. uv (num_features, 2), level,
// score, valid (num_features,).
extern "C" int rgbd_detect_keypoints(const void* const* imgs, const int* hs, const int* ws,
                                     int n_levels, int cell_size, int grid_rows,
                                     int grid_cols, const void* thr, int fast_gate,
                                     int min_border, float min_response, int scale_gate,
                                     float gate_scale, int num_features, int subpixel,
                                     void* cell_max, void* cell_arg, void* cell_off, void* uv,
                                     void* level, void* score, void* valid, void* stream) {
  const int n_cells = grid_rows * grid_cols;
  if (n_levels < 1 || n_cells < 1 || num_features < 1 || (cell_size >> (n_levels - 1)) < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float2* off = subpixel ? (float2*)cell_off : nullptr;
  for (int g0 = 0; g0 < n_levels; g0 += kTableLevels) {
    LevelTable tab;
    tab.n_levels = n_levels - g0 < kTableLevels ? n_levels - g0 : kTableLevels;
    tab.base_level = g0;
    tab.zero_entry = (subpixel && g0 == 0) ? n_levels * n_cells : -1;
    for (int l = 0; l < tab.n_levels; ++l) {
      tab.img[l] = (const float*)imgs[g0 + l];
      tab.h[l] = hs[g0 + l];
      tab.w[l] = ws[g0 + l];
      tab.cell[l] = cell_size >> (g0 + l);
      tab.rows[l] = grid_rows;
      tab.cols[l] = grid_cols;
      tab.bshift[l] = g0 + l;
      tab.bh[l] = hs[0];
      tab.bw[l] = ws[0];
      tab.quota[l] = tab.first_slot[l] = 0;
    }
    bool fixed;
    int tile_smem;
    if (!plan_tiles(tab, fixed, tile_smem)) return (int)cudaErrorInvalidValue;
    const size_t first = (size_t)g0 * n_cells;
    const cudaError_t launched = launch_cells(
        tab, fixed, tile_smem, (const float*)thr, fast_gate, min_border,
        (float*)cell_max + first, (int*)cell_arg + first, off ? off + first : nullptr, st);
    if (launched != cudaSuccess) return (int)launched;
  }
  const int chunk = stage_chunk(n_cells);
  const int bytes = chunk * (int)sizeof(float);
  const cudaError_t e = allow_smem(detect_select_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  detect_select_kernel<<<(n_cells + kSelCells - 1) / kSelCells, kSelThreads, bytes, st>>>(
      (const float*)cell_max, (const int*)cell_arg, off, n_levels, n_cells, grid_cols,
      cell_size, (const float*)thr, scale_gate, gate_scale, min_response, num_features, chunk,
      (float*)uv, (int*)level, (float*)score, (unsigned char*)valid);
  return (int)cudaGetLastError();
}

// The whole detection of the x1.2 scale space on one stream: kernel A over
// the tiles of every level (each level's own grid of cell_size cells and its
// own border), then kernel C, each level's cells ranked into its quota of
// slots; one launch of each a group of kTableLevels levels. imgs, hs, ws,
// quotas: host arrays of n_levels entries; a level with quota <= 0 is not
// read and has no slots, and a level too small for one cell has none either
// (its quota, zero with the plain version's caps, only pads). thr,
// fast_gate, scale_gate, gate_scale, min_response: as rgbd_detect_keypoints.
// cell_max, cell_arg: (sum of the levels' cells,) in level order; cell_off
// (that, 2) f32 with `subpixel`, else unused (null). uv (N, 2) in level
// pixels, level, score, valid (N,), N = the sum of the positive quotas, the
// levels' slots in level order.
extern "C" int rgbd_detect_scaled(const void* const* imgs, const int* hs, const int* ws,
                                  const int* quotas, int n_levels, int cell_size,
                                  const void* thr, int fast_gate, int min_border,
                                  float min_response, int scale_gate, float gate_scale,
                                  int subpixel, void* cell_max, void* cell_arg,
                                  void* cell_off, void* uv, void* level, void* score,
                                  void* valid, void* stream) {
  if (n_levels < 1 || cell_size < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float2* off = subpixel ? (float2*)cell_off : nullptr;
  int slots = 0, max_cells = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (quotas[l] <= 0) continue;
    const int n = (hs[l] / cell_size) * (ws[l] / cell_size);
    max_cells = n > max_cells ? n : max_cells;
    slots += quotas[l];
  }
  if (slots < 1) return (int)cudaErrorInvalidValue;
  const int chunk = stage_chunk(max_cells);
  const int rank_bytes = chunk * (int)sizeof(float);
  const cudaError_t e = allow_smem(detect_rank_kernel, rank_bytes);
  if (e != cudaSuccess) return (int)e;
  size_t cells_before = 0;
  int slots_before = 0;
  for (int g0 = 0; g0 < n_levels; g0 += kTableLevels) {
    LevelTable tab;
    tab.n_levels = n_levels - g0 < kTableLevels ? n_levels - g0 : kTableLevels;
    tab.base_level = g0;
    tab.zero_entry = -1;
    int group_slots = 0, rank_blocks = 0;
    for (int l = 0; l < tab.n_levels; ++l) {
      const int q = quotas[g0 + l];
      const bool on = q > 0;
      tab.img[l] = (const float*)imgs[g0 + l];
      tab.h[l] = hs[g0 + l];
      tab.w[l] = ws[g0 + l];
      tab.cell[l] = cell_size;
      tab.rows[l] = on ? hs[g0 + l] / cell_size : 0;
      tab.cols[l] = on ? ws[g0 + l] / cell_size : 0;
      tab.bshift[l] = 0;
      tab.bh[l] = hs[g0 + l];
      tab.bw[l] = ws[g0 + l];
      tab.quota[l] = on ? q : 0;
      tab.first_slot[l] = slots_before + group_slots;
      tab.first_rank_block[l] = rank_blocks;
      const int n = tab.rows[l] * tab.cols[l];
      group_slots += tab.quota[l];
      rank_blocks += on ? (n > kSelCells ? (n + kSelCells - 1) / kSelCells : 1) : 0;
    }
    for (int l = tab.n_levels; l <= kTableLevels; ++l) tab.first_rank_block[l] = rank_blocks;
    bool fixed;
    int tile_smem;
    if (!plan_tiles(tab, fixed, tile_smem)) return (int)cudaErrorInvalidValue;
    float* cmax = (float*)cell_max + cells_before;
    int* carg = (int*)cell_arg + cells_before;
    float2* coff = off ? off + cells_before : nullptr;
    const cudaError_t launched = launch_cells(tab, fixed, tile_smem, (const float*)thr,
                                              fast_gate, min_border, cmax, carg, coff, st);
    if (launched != cudaSuccess) return (int)launched;
    if (rank_blocks > 0) {
      detect_rank_kernel<<<rank_blocks, kSelThreads, rank_bytes, st>>>(
          tab, cmax, carg, coff, (const float*)thr, scale_gate, gate_scale, min_response,
          chunk, (float*)uv, (int*)level, (float*)score, (unsigned char*)valid);
      const cudaError_t r = cudaGetLastError();
      if (r != cudaSuccess) return (int)r;
    }
    cells_before += tab.first_cell[kTableLevels];
    slots_before += group_slots;
  }
  return (int)cudaSuccess;
}
