"""The detection configurations the card took last: cells wider than a tile,
any number of x1.2 levels (levels too small for one cell among them) and
more cells on a level than shared memory holds. The routes of csrc/detect.cu
that run them are modelled step by step in PyTorch and held against the
port's plain detection, and the plain detection against the JAX package's.

- Kernel A, a cell wider than 32 pixels (`model_wide_cells`): one block a
  cell walks the cell's 32 x 16 sub-tiles (`kernels.whole_cell_tile`), each
  reduced to its first maximum by (value, index in the cell's row-major
  order), the best kept over the sub-tiles, with the parabola offsets taken
  at each sub-tile's winner from that sub-tile's raw scores and their
  1-pixel halo. Exact against `fast.detect_cells_ref` and
  `fast.detect_scaled_cells_ref`.
- Kernels B and C past shared memory (`model_select_chunked`,
  `_chunked_ranks`): the scores staged in chunks, each warp's count
  added over the chunks, a warp merging its own cell's levels. Exact
  against `fast.detect_select_ref` and `fast.detect_scaled_select_ref` (the
  chunk is shrunk so that a CPU counts n x chunk comparisons quickly; the
  kernels' is 8,192 cells, past the 58,112 a block's shared memory stages
  whole).
- The plain detections against the JAX package's (XLA composition, jitted)
  at 320x240: uv, level and valid exact, the score within the tolerance the
  two packages' score maps are held to (rtol 1e-5, atol 1e-3), subpixel
  positions within 1e-4 px (tests/test_torch_detect_fused.py's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.ops import fast as jfast
from rgbdslam_tpu.ops import image as jimg
from rgbdslam_tpu_torch.ops import fast as tfast
from rgbdslam_tpu_torch.ops import image as timg
from rgbdslam_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEG_INF = float("-inf")
BIG = 2 ** 31 - 1


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        img = rng.integers(0, 256, shape).astype(np.float32)
    else:                             # an 8-pixel period: every cell's maximum repeats
        tile = rng.integers(0, 256, (8, 8)).astype(np.float32)
        img = np.tile(tile, (shape[0] // 8 + 1, shape[1] // 8 + 1))[: shape[0], : shape[1]]
    img[: shape[0] // 3, : shape[1] // 3] = 0.0         # a corner with no corner
    return img


def _beats(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def model_wide_level(img, cell, grid, bshift, frame, thr, border, subpixel):
    """Kernel A's route for cells wider than a tile on one level: per cell
    the sub-tiles in order, each reduced to (max, first index) as the
    block's warps and thread 0 reduce it, merged into the running winner
    with the offsets at the sub-tile's winner. Returns (cell_max, cell_arg,
    cell_off or None, raw)."""
    assert cell > kernels.DETECT_TILE_CELL
    TW, TH = kernels.whole_cell_tile(cell)
    assert (TW, TH) == (32, 16)
    h, w = img.shape
    rows, cols = grid
    masked, raw = kernels.detect_score_map_ref(img, thr)
    X = torch.arange(w) << bshift
    Y = torch.arange(h) << bshift
    inb = ((X >= border) & (X < frame[1] - border))[None, :] \
        & ((Y >= border) & (Y < frame[0] - border))[:, None]
    gated = torch.where(inb, masked, NEG_INF)
    n = rows * cols
    cell_max = torch.empty(n)
    cell_arg = torch.empty(n, dtype=torch.int32)
    cell_off = torch.empty(n, 2)
    for ci in range(n):
        X0, Y0 = (ci % cols) * cell, (ci // cols) * cell
        best, barg, boff = NEG_INF, BIG, (0.0, 0.0)
        for y0 in range(Y0, Y0 + cell, TH):
            for x0 in range(X0, X0 + cell, TW):
                ys = slice(y0, min(y0 + TH, Y0 + cell))
                xs = slice(x0, min(x0 + TW, X0 + cell))
                sub = gated[ys, xs]
                ly = torch.arange(ys.start, ys.stop)[:, None] - Y0
                lx = torch.arange(xs.start, xs.stop)[None, :] - X0
                idx = (ly * cell + lx).reshape(-1)
                v = float(sub.max())
                i = int(idx[sub.reshape(-1) == v].min())
                if _beats(v, i, best, barg):
                    best, barg = v, i
                    if subpixel:
                        px, py = X0 + i % cell, Y0 + i // cell
                        # the neighbours lie in the sub-tile's 1-pixel halo
                        assert x0 - 1 <= px - 1 and px + 1 <= x0 + TW
                        assert y0 - 1 <= py - 1 and py + 1 <= y0 + TH
                        ox, oy = tfast._subpixel_offsets(raw, torch.tensor([px]),
                                                         torch.tensor([py]))
                        boff = (float(ox[0]), float(oy[0]))
        assert barg < cell * cell
        cell_max[ci], cell_arg[ci] = best, barg
        cell_off[ci] = torch.tensor(boff)
    return cell_max, cell_arg, (cell_off if subpixel else None), raw


def model_cells(pyramid, cell_size, thr, border, subpixel):
    """Kernel A on the half-sample pyramid where level 0's cell (at least)
    is wider than a tile: those levels by the wide route, the rest by the
    plain cells (their tiles of whole cells are tests/test_torch_detect_fused.py's)."""
    h0, w0 = pyramid[0].shape
    grid = (h0 // cell_size, w0 // cell_size)
    levels = pyramid[:tfast.used_levels(len(pyramid), cell_size)]
    plain = tfast.detect_cells_ref(levels, cell_size, thr, border, True, subpixel)
    maxima, args, offs = list(plain[0]), list(plain[1]), None
    if subpixel:
        n = grid[0] * grid[1]
        offs = [plain[2][lvl * n:(lvl + 1) * n] for lvl in range(len(levels))]
    raw0 = None
    for lvl, img in enumerate(levels):
        if cell_size >> lvl > kernels.DETECT_TILE_CELL:
            cmax, carg, coff, raw = model_wide_level(img, cell_size >> lvl, grid, lvl,
                                                     (h0, w0), thr, border, subpixel)
            maxima[lvl], args[lvl] = cmax, carg
            if subpixel:
                offs[lvl] = coff
            if lvl == 0:
                raw0 = raw
    out = (torch.stack(maxima), torch.stack(args))
    if not subpixel:
        return out
    zero = torch.stack(tfast._subpixel_offsets(raw0, torch.zeros(1, dtype=torch.int64),
                                               torch.zeros(1, dtype=torch.int64)), -1)
    return out + (torch.cat(offs + [zero]),)


@pytest.mark.parametrize("cell", [33, 40, 64])
@pytest.mark.parametrize("kind,subpixel", [("periodic", False), ("integer", True)])
def test_wide_cells_half_sample_model_and_jax(cell, kind, subpixel):
    """Kernel A's wide route on the upper levels of the half-sample pyramid
    (64 -> 64, then 32, 16 in whole-cell tiles), modelled sub-tile by
    sub-tile, against the plain cells; the whole plain detection against
    the JAX package's."""
    img = _image(kind, (240, 320), seed=cell)
    pyr = timg.build_pyramid(torch.from_numpy(img), 3)
    model = model_cells(pyr, cell, 20.0, 8, subpixel)
    plain = tfast.detect_cells_ref(pyr, cell, 20.0, 8, True, subpixel)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    if kind == "periodic":       # the first of a cell's repeated maxima won, across sub-tiles
        gated = tfast._border_gate(kernels.detect_score_map_ref(pyr[0], 20.0)[0], 1,
                                   (240, 320), 8)
        cols, tied = 320 // cell, 0
        for ci in range(plain[0].shape[1]):
            y, x = (ci // cols) * cell, (ci % cols) * cell
            if torch.isfinite(plain[0][0, ci]):
                hits = torch.nonzero(gated[y:y + cell, x:x + cell] == plain[0][0, ci])
                assert int(plain[1][0, ci]) == int(hits[0, 0] * cell + hits[0, 1])
                tied += int(hits[:, 0].max() >= 16 or hits[:, 1].max() >= 32)
        assert tied > 5
    kw = dict(num_features=256, cell_size=cell, fast_threshold=20.0, min_response=20.0,
              min_border=8, subpixel=subpixel)
    kp = tfast.detect_keypoints_ref(pyr, **kw)
    assert int(kp.valid.sum()) > 10 and not bool(kp.valid[(240 // cell) * (320 // cell):].any())
    if kind == "periodic":    # XLA's FMAs decide some of these ties otherwise
        return
    kj = jax.jit(lambda *lv: jfast.detect_keypoints(
        list(lv), 256, cell, 20.0, 20.0, 8, use_pallas=False, subpixel=subpixel))(
            *[jnp.asarray(p.numpy()) for p in pyr])
    _like_jax(kp, kj.uv, kj.valid, kj.level, kj.score, subpixel)


def _like_jax(kp, uv, valid, level, score, subpixel):
    uv, valid, level, score = (np.asarray(a) for a in (uv, valid, level, score))
    np.testing.assert_array_equal(kp.valid.numpy(), valid)
    np.testing.assert_array_equal(kp.level.numpy(), level)
    if subpixel:
        np.testing.assert_allclose(kp.uv.numpy()[valid], uv[valid], rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(kp.uv.numpy(), uv)
    np.testing.assert_allclose(kp.score.numpy(), score, rtol=1e-5, atol=1e-3)


def _jax_scaled(pyr, quotas, cell, gate, subpixel):
    """JAX's detect_keypoints_level on every level with a positive quota
    (its x1.2 build's loop, frame.py:166-207), slots end to end."""
    parts = [jax.jit(lambda x, q=q: jfast.detect_keypoints_level(
        x, q, cell, 20.0, float(gate), 8, use_pallas=False, subpixel=subpixel))(
            jnp.asarray(p.numpy())) for p, q in zip(pyr, quotas) if q > 0]
    levels = [np.full(q, lvl, np.int32) for lvl, q in enumerate(quotas) if q > 0]
    return (np.concatenate([np.asarray(k.uv) for k in parts]),
            np.concatenate([np.asarray(k.valid) for k in parts]), np.concatenate(levels),
            np.concatenate([np.asarray(k.score) for k in parts]))


@pytest.mark.parametrize("cell,levels,subpixel", [(40, 8, False), (64, 12, True),
                                                  (16, 9, False), (16, 12, True)])
def test_scaled_wide_cells_and_many_levels_model_and_jax(cell, levels, subpixel):
    """The x1.2 scale space at cells wider than a tile (every level by the
    wide route) and at 9 and 12 levels; at cells of 64 on 320x240 levels 8-11
    are too small for one cell and the quotas (the JAX package's, equal)
    give them no slot. Kernel A's route modelled against the plain cells,
    the plain detection against JAX's per-level detections."""
    img = _image("integer", (240, 320), seed=cell + levels)
    pyr = timg.build_scaled_pyramid(torch.from_numpy(img), levels, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    jshapes = [tuple(p.shape) for p in jimg.build_scaled_pyramid(jnp.asarray(img), levels, 1.2)]
    assert shapes == jshapes
    quotas = tfast.level_quotas(256, levels, 1.2, cell, shapes)
    assert quotas == jfast.level_quotas(256, levels, 1.2, cell, jshapes)
    empty = [lvl for lvl, (h, w) in enumerate(shapes) if (h // cell) * (w // cell) == 0]
    if cell == 64:
        assert empty == [8, 9, 10, 11] and all(quotas[lvl] == 0 for lvl in empty)
    plain = tfast.detect_scaled_cells_ref(pyr, quotas, cell, 20.0, 8, True, subpixel)
    if cell > kernels.DETECT_TILE_CELL:
        parts = [model_wide_level(p, cell, (p.shape[0] // cell, p.shape[1] // cell), 0,
                                  tuple(p.shape), 20.0, 8, subpixel)
                 for p, q in zip(pyr, quotas) if q > 0]
        assert torch.equal(torch.cat([m[0] for m in parts]), plain[0])
        assert torch.equal(torch.cat([m[1] for m in parts]), plain[1])
        if subpixel:
            assert torch.equal(torch.cat([m[2] for m in parts]), plain[2])
    gate = tfast.response_gate(20.0, 20.0, 20.0)
    kp = tfast.detect_keypoints_scaled_ref(pyr, quotas, cell, 20.0, 20.0, 8, True, 20.0,
                                           subpixel)
    assert kp.uv.shape[0] == 256 == sum(q for q in quotas if q > 0)
    _like_jax(kp, *_jax_scaled(pyr, quotas, cell, gate, subpixel), subpixel)
    assert int(kp.valid.sum()) > 20


def _merged(cell_max):
    """Each cell's best over the levels in level order, strict >, and its
    level (kernel B's merged_cell; 255 where no level beats -inf)."""
    best = torch.full(cell_max.shape[1:], NEG_INF)
    level = torch.full(cell_max.shape[1:], 255, dtype=torch.int32)
    for lvl in range(cell_max.shape[0]):
        upd = cell_max[lvl] > best
        best = torch.where(upd, cell_max[lvl], best)
        level = torch.where(upd, lvl, level).to(torch.int32)
    return best, level


def _chunked_ranks(scores, si, chunk):
    """Each cell's rank as the kernels count it past shared memory: the
    scores staged chunk by chunk (padded with -inf to a multiple of 32),
    every cell's count of greater scores and of equal ones at a lower
    index added over the chunks."""
    n = scores.shape[0]
    n_pad = (n + 31) // 32 * 32
    padded = torch.cat([scores, torch.full((n_pad - n,), NEG_INF)])
    idx = torch.arange(n)
    rank = torch.zeros(n, dtype=torch.int64)
    for c0 in range(0, n_pad, chunk):
        s = padded[c0:c0 + chunk]
        j = c0 + torch.arange(s.shape[0])
        rank += ((s[None, :] > si[:, None])
                 | ((s[None, :] == si[:, None]) & (j[None, :] < idx[:, None]))).sum(1)
    return rank


def model_select_chunked(cell_max, cell_arg, grid_cols, num_features, cell_size,
                         min_response, chunk):
    """Kernel B past shared memory: a warp merges its own cell (its gated
    score before the first chunk, its level when it writes), the block
    stages the merged, gated scores chunk by chunk."""
    best, level = _merged(cell_max)
    sel = torch.where(best > min_response, best, NEG_INF)
    rank = _chunked_ranks(sel, sel, chunk)
    n_cells = best.shape[0]
    assert sorted(rank.tolist()) == list(range(n_cells))      # one writer a slot
    k = min(num_features, n_cells)
    uv = torch.zeros((num_features, 2))
    lev = torch.zeros((num_features,), dtype=torch.int32)
    score = torch.zeros((num_features,))
    valid = torch.zeros((num_features,), dtype=torch.bool)
    for i in torch.nonzero(rank < k)[:, 0].tolist():
        r, lv = int(rank[i]), int(level[i])
        u = v = 0
        if lv == 255:
            lv = 0
        else:
            cl = cell_size >> lv
            a = int(cell_arg[lv, i])
            u = ((i % grid_cols) * cl + a % cl) << lv
            v = ((i // grid_cols) * cl + a // cl) << lv
        ok = bool(sel[i] > min_response)
        uv[r, 0], uv[r, 1] = float(u), float(v)
        lev[r], score[r], valid[r] = lv, float(sel[i]) if ok else 0.0, ok
    return tfast.Keypoints(uv=uv, level=lev, score=score, valid=valid)


@pytest.mark.parametrize("chunk", [256, 1024])
def test_select_chunked_model_ranks_like_plain(chunk):
    """Kernel B's chunked route on injected cell maxima with ties, -inf and
    NaN over three levels (5,000 cells, chunks of 256 and 1,024 cells: the
    route is the same at 76,800 cells and chunks of 8,192), exactly against
    the plain stable sort."""
    rng = np.random.default_rng(chunk)
    L, cell, grid_cols, n_cells = 3, 8, 100, 5000
    cmax = (rng.integers(0, 40, (L, n_cells)) * 5.0).astype(np.float32)
    cmax[rng.random((L, n_cells)) < 0.3] = -np.inf
    cmax[rng.random((L, n_cells)) < 0.05] = np.nan
    carg = np.stack([rng.integers(0, (cell >> lvl) ** 2, n_cells) for lvl in range(L)]
                    ).astype(np.int32)
    cmax, carg = torch.from_numpy(cmax), torch.from_numpy(carg)
    for n_feat in (1024, 6000):
        ref = tfast.detect_select_ref(cmax, carg, grid_cols, n_feat, cell, 20.0)
        mk = model_select_chunked(cmax, carg, grid_cols, n_feat, cell, 20.0, chunk)
        for f in ("uv", "level", "score", "valid"):
            assert torch.equal(getattr(mk, f), getattr(ref, f)), f


def test_rank_chunked_model_and_76800_cells_against_jax():
    """Kernel C's chunked route (a level's ungated maxima, -inf cells by
    index) modelled on one x1.2 level of injected maxima against the plain
    ranking; then 76,800 cells (cells of 1 at 320x240) through the plain
    half-sample and x1.2 detections against the JAX package's."""
    rng = np.random.default_rng(3)
    n, cols, cell, quota = 3000, 60, 4, 700
    cmax = (rng.integers(0, 30, n) * 3.0).astype(np.float32)
    cmax[rng.random(n) < 0.4] = -np.inf
    cmax = torch.from_numpy(cmax)
    carg = torch.from_numpy(rng.integers(0, cell * cell, n).astype(np.int32))
    rank = _chunked_ranks(cmax, cmax, 512)
    ref = tfast.detect_scaled_select_ref(cmax, carg, None, [(n // cols * cell, cols * cell)],
                                         [quota], cell, 20.0)
    top = torch.argsort(rank)[:quota]
    cells = torch.arange(n)[top]
    u = ((cells % cols) * cell + carg[top] % cell).to(torch.float32)
    v = ((cells // cols) * cell + carg[top] // cell).to(torch.float32)
    assert torch.equal(ref.uv, torch.stack([u, v], -1))
    ok = torch.isfinite(cmax[top]) & (cmax[top] > 20.0)
    assert torch.equal(ref.valid, ok)

    img = _image("integer", (240, 320), seed=76800)
    pyr = timg.build_pyramid(torch.from_numpy(img), 2)
    assert (240 // 1) * (320 // 1) == 76800 > 58112
    kp = tfast.detect_keypoints_ref(pyr, 2048, 1, 20.0, 20.0, 8)
    kj = jax.jit(lambda *lv: jfast.detect_keypoints(list(lv), 2048, 1, 20.0, 20.0, 8,
                                                    use_pallas=False))(
        *[jnp.asarray(p.numpy()) for p in pyr])
    _like_jax(kp, kj.uv, kj.valid, kj.level, kj.score, False)
    assert int(kp.valid.sum()) > 1000
    x12 = timg.build_scaled_pyramid(torch.from_numpy(img), 3, 1.2)
    quotas = tfast.level_quotas(2048, 3, 1.2, 1, [tuple(p.shape) for p in x12])
    kp12 = tfast.detect_keypoints_scaled_ref(x12, quotas, 1, 20.0, 20.0, 8, True, 20.0)
    gate = tfast.response_gate(20.0, 20.0, 20.0)
    _like_jax(kp12, *_jax_scaled(x12, quotas, 1, gate, False), False)
