"""The whole-detection kernels of csrc/detect.cu, modelled step by step in
PyTorch, against the port's plain detection and the JAX package's.

A CUDA kernel cannot run without a card, so what is tested here is its
algorithm: `model_cells` walks the pyramid levels tile by tile (tiles of
whole cells, `kernels.whole_cell_tile`: 32x16 for cells of 1, 2, 4, 8, 16
pixels, 30x15 for 5, 24x24 for 24, as kernel A's blocks do), gates the
border in level-0 coordinates (the x1.2 mode: each level's own) and finds
each cell's maximum in two stages, rows of a cell first and then the cell's
rows, each a strict-> scan, which must give the first maximum of the cell in
row-major order, and with subpixel offsets the parabola at the winner read
from the tile's raw scores and their 1-pixel halo; `model_select` merges the levels with strict >, gates by
the response, ranks the cells by counting (cells with a greater score plus
cells with an equal score and a lower index) and writes the padded keypoint
slots, as kernel B does. Both are held exactly against
`fast.detect_cells_ref` / `fast.detect_select_ref` / `detect_keypoints_ref`,
and against `rgbdslam_tpu.ops.fast.detect_keypoints` (XLA composition):
uv, level and valid exact, the score within the tolerance the two packages'
score maps are held to (rtol 1e-5, atol 1e-3, tests/test_torch_detect.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.geometry.camera import Camera as JCamera
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JDataset
from rgbdslam_tpu.ops import fast as jfast
from rgbdslam_tpu.ops import image as jimg
from rgbdslam_tpu_torch.ops import fast as tfast
from rgbdslam_tpu_torch.ops import image as timg
from rgbdslam_tpu_torch.ops import kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEG_INF = float("-inf")


def _first_max_scan(x):
    """Strict-> scan along the last axis: (maximum, first index), as a
    thread of kernel A runs it."""
    best = x[..., 0].clone()
    arg = torch.zeros(x.shape[:-1], dtype=torch.int64)
    for k in range(1, x.shape[-1]):
        upd = x[..., k] > best
        best = torch.where(upd, x[..., k], best)
        arg = torch.where(upd, k, arg)
    return best, arg


def model_level(img, cell_l, grid, bshift, frame, fast_threshold, min_border, subpixel):
    """Kernel A on one level: its tiles of whole cells, per tile the gated
    scores, the row stage and the cell stage, a cell written by the one tile
    that holds it; with `subpixel` the parabola offsets at each winner from
    the tile's raw scores (1-pixel halo; neighbours clamped into the level).
    Returns (cell_max (n,), cell_arg (n,) int32, cell_off (n, 2) or None)
    and the tile's raw window function (for pixel (0, 0))."""
    h, w = img.shape
    grid_rows, grid_cols = grid
    TW, TH = kernels.whole_cell_tile(cell_l)
    assert TW % cell_l == 0 and TH % cell_l == 0 and TW <= 32 and TH <= 32
    masked, raw = kernels.detect_score_map_ref(img, fast_threshold)
    n = grid_rows * grid_cols
    cell_max = torch.full((n,), float("nan"))
    cell_arg = torch.full((n,), -1, dtype=torch.int32)
    cell_off = torch.full((n, 2), float("nan"))
    written = torch.zeros((n,), dtype=torch.int32)

    def tile_offset(x0, y0, px, py):
        # the tile holds raw scores at x0 - 1 .. x0 + TW, y0 - 1 .. y0 + TH
        um, up = max(px - 1, 0), min(px + 1, w - 1)
        vm, vp = max(py - 1, 0), min(py + 1, h - 1)
        for x in (um, up):
            assert x0 - 1 <= x <= x0 + TW
        for y in (vm, vp):
            assert y0 - 1 <= y <= y0 + TH
        c = raw[py, px]
        return (float(tfast._parabola_offset(raw[py, um], c, raw[py, up])),
                float(tfast._parabola_offset(raw[vm, px], c, raw[vp, px])))

    hc, wc = grid_rows * cell_l, grid_cols * cell_l
    for y0 in range(0, hc, TH):
        for x0 in range(0, wc, TW):
            tile = torch.full((TH, TW), NEG_INF)
            th_, tw_ = min(TH, h - y0), min(TW, w - x0)
            tile[:th_, :tw_] = masked[y0:y0 + th_, x0:x0 + tw_]
            X = (x0 + torch.arange(TW)) << bshift
            Y = (y0 + torch.arange(TH)) << bshift
            inb = ((X >= min_border) & (X < frame[1] - min_border))[None, :] \
                & ((Y >= min_border) & (Y < frame[0] - min_border))[:, None]
            s_out = torch.where(inb, tile, NEG_INF)
            segs = TW // cell_l
            # stage 1: thread (row, seg) scans its cell_l pixels
            rmax, rarg = _first_max_scan(s_out.reshape(TH, segs, cell_l))
            # stage 2: thread (cell row, seg) scans its cell's cell_l rows
            rmax = rmax.reshape(TH // cell_l, cell_l, segs).permute(0, 2, 1)
            rarg = rarg.reshape(TH // cell_l, cell_l, segs).permute(0, 2, 1)
            best, j = _first_max_scan(rmax)
            arg = j * cell_l + torch.gather(rarg, -1, j[..., None])[..., 0]
            for cyl in range(TH // cell_l):
                for cxl in range(segs):
                    cy, cx = y0 // cell_l + cyl, x0 // cell_l + cxl
                    if cy < grid_rows and cx < grid_cols:
                        idx = cy * grid_cols + cx
                        a = int(arg[cyl, cxl])
                        cell_max[idx] = best[cyl, cxl]
                        cell_arg[idx] = a
                        written[idx] += 1
                        if subpixel:
                            cell_off[idx] = torch.tensor(tile_offset(
                                x0, y0, cx * cell_l + a % cell_l, cy * cell_l + a // cell_l))
    assert bool((written == 1).all())        # one writer a cell: no atomics needed
    return cell_max, cell_arg, (cell_off if subpixel else None), tile_offset


def model_cells(pyramid, cell_size, fast_threshold, min_border, subpixel=False):
    """Kernel A on the half-sample pyramid: cells of cell_size >> level on
    the level-0 grid, the border in level-0 coordinates. Returns (cell_max
    (L, n_cells), cell_arg (L, n_cells) int32[, cell_off (L n_cells + 1, 2)
    with the offsets of pixel (0, 0) of level 0 last])."""
    h0, w0 = pyramid[0].shape
    grid = (h0 // cell_size, w0 // cell_size)
    levels = pyramid[:tfast.used_levels(len(pyramid), cell_size)]
    outs = [model_level(img, cell_size >> lvl, grid, lvl, (h0, w0), fast_threshold,
                        min_border, subpixel) for lvl, img in enumerate(levels)]
    cell_max = torch.stack([o[0] for o in outs])
    cell_arg = torch.stack([o[1] for o in outs])
    if not subpixel:
        return cell_max, cell_arg
    zero = torch.tensor([outs[0][3](0, 0, 0, 0)])       # the block of tile 0 on level 0
    return cell_max, cell_arg, torch.cat([o[2] for o in outs] + [zero])


def model_scaled_cells(pyramid, quotas, cell_size, fast_threshold, min_border, subpixel):
    """Kernel A's x1.2 mode: cell_size cells on each level's own grid, the
    border in the level's own pixels; the levels with a positive quota end
    to end."""
    outs = [model_level(img, cell_size, (img.shape[0] // cell_size, img.shape[1] // cell_size),
                        0, tuple(img.shape), fast_threshold, min_border, subpixel)
            for img, q in zip(pyramid, quotas) if q > 0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs]) if subpixel else None)


def model_select(cell_max, cell_arg, grid_cols, num_features, cell_size, min_response):
    """Kernel B: merge, gate, rank by counting, write the slots."""
    n_levels, n_cells = cell_max.shape
    best = torch.full((n_cells,), NEG_INF)
    level = torch.zeros((n_cells,), dtype=torch.int32)
    for lvl in range(n_levels):
        upd = cell_max[lvl] > best
        best = torch.where(upd, cell_max[lvl], best)
        level = torch.where(upd, lvl, level).to(torch.int32)
    sel = torch.where(best > min_response, best, NEG_INF)
    idx = torch.arange(n_cells)
    ahead = (sel[None, :] > sel[:, None]) | ((sel[None, :] == sel[:, None])
                                            & (idx[None, :] < idx[:, None]))
    rank = ahead.sum(1)
    assert sorted(rank.tolist()) == list(range(n_cells))     # one writer a slot
    k = min(num_features, n_cells)
    uv = torch.zeros((num_features, 2))
    lev = torch.zeros((num_features,), dtype=torch.int32)
    score = torch.zeros((num_features,))
    valid = torch.zeros((num_features,), dtype=torch.bool)
    for i in range(n_cells):
        r = int(rank[i])
        if r >= k:
            continue
        u = v = 0
        if best[i] > NEG_INF:
            l = int(level[i])
            cell_l = cell_size >> l
            a = int(cell_arg[l, i])
            u = ((i % grid_cols) * cell_l + a % cell_l) << l
            v = ((i // grid_cols) * cell_l + a // cell_l) << l
        ok = bool(sel[i] > min_response)
        uv[r, 0], uv[r, 1] = float(u), float(v)
        lev[r] = int(level[i])
        score[r] = float(sel[i]) if ok else 0.0
        valid[r] = ok
    return tfast.Keypoints(uv=uv, level=lev, score=score, valid=valid)


def _same(a, b):
    for f in ("uv", "level", "score", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f


def _rendered(h, w):
    cam = JCamera(200.0 * w / 320, 200.0 * w / 320, (w - 1) / 2, (h - 1) / 2, width=w, height=h)
    return np.asarray(JDataset(n_frames=24, cam=cam, trajectory="sweep").grab(3)[1])


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(0, 256, shape).astype(np.float32)
    if kind == "coarse":              # four grey values: equal scores are common
        return (rng.integers(0, 4, shape) * 64).astype(np.float32)
    if kind == "dark":
        return np.zeros(shape, np.float32)
    return _rendered(*shape)


CASES = [
    # kind, (h, w), levels, cell_size, FAST threshold, min_border, num_features
    ("integer", (240, 320), 3, 8, 20.0, 16, 512),
    ("coarse", (240, 320), 3, 8, 20.0, 16, 512),
    ("coarse", (120, 160), 4, 16, 20.0, 8, 64),       # cells of 16, 8, 4, 2 pixels
    ("rendered", (240, 320), 3, 8, 15.0, 16, 1024),
    ("rendered", (150, 200), 3, 8, 15.0, 9, 256),     # levels are not whole tiles
    ("integer", (75, 101), 2, 4, 20.0, 5, 128),       # odd sizes, cropped cells
    ("dark", (96, 128), 3, 8, 20.0, 8, 64),           # no corner at all
    ("integer", (64, 96), 3, 8, 20.0, 4, 200),        # more slots than cells: padding
]


@pytest.mark.parametrize("kind,shape,levels,cell,thr,border,n_feat", CASES)
def test_detection_model_matches_plain_and_jax(kind, shape, levels, cell, thr, border, n_feat):
    img = _image(kind, shape, seed=shape[0] + levels)
    pt = timg.build_pyramid(torch.from_numpy(img), levels)
    kw = dict(num_features=n_feat, cell_size=cell, fast_threshold=thr, min_response=20.0,
              min_border=border)
    grid_cols = shape[1] // cell
    # kernel A's model against the first half of the plain version
    mmax, marg = model_cells(pt, cell, thr, border)
    pmax, parg = tfast.detect_cells_ref(pt, cell, thr, border)
    assert torch.equal(mmax, pmax) and torch.equal(marg, parg)
    # kernel B's model against the second half, and the whole against the whole
    mk = model_select(mmax, marg, grid_cols, n_feat, cell, 20.0)
    _same(mk, tfast.detect_select_ref(pmax, parg, grid_cols, n_feat, cell, 20.0))
    ref = tfast.detect_keypoints_ref(pt, **kw)
    _same(mk, ref)
    _same(ref, tfast.detect_keypoints(pt, **kw))           # CPU tensors: the plain version
    # the JAX package on the same image: its Pallas kernel (interpreted on
    # the CPU) sums in the plain version's order; on integer images, where
    # every order gives the same sums, the XLA composition
    kj = jfast.detect_keypoints(jimg.build_pyramid(jnp.asarray(img), levels),
                                use_pallas=kind in ("rendered", "coarse"), **kw)
    np.testing.assert_array_equal(mk.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_allclose(mk.score.numpy(), np.asarray(kj.score), rtol=1e-5, atol=1e-3)
    if kind != "coarse":
        np.testing.assert_array_equal(mk.uv.numpy(), np.asarray(kj.uv))
        np.testing.assert_array_equal(mk.level.numpy(), np.asarray(kj.level))
    else:
        # XLA contracts a*b + c into an FMA on the CPU, so its scores differ
        # from torch's in the last bit, and where torch sees two equal scores
        # XLA may see a greater one: a few cells then rank or resolve
        # otherwise; the exact comparison of such images is the plain
        # version's above
        ours = {tuple(r) for r in torch.cat([mk.uv, mk.level[:, None]], 1)[mk.valid].tolist()}
        theirs = np.concatenate([np.asarray(kj.uv), np.asarray(kj.level)[:, None]], 1)
        theirs = {tuple(r) for r in theirs[np.asarray(kj.valid)].tolist()}
        assert len(ours ^ theirs) <= 0.02 * len(ours)
    n_cells = (shape[0] // cell) * grid_cols
    if kind == "dark":
        assert not bool(mk.valid.any()) and float(mk.uv.abs().sum()) == 0.0
        assert float(mk.score.abs().sum()) == 0.0 and int(mk.level.sum()) == 0
    else:
        assert int(mk.valid.sum()) > min(n_feat, n_cells) // 8
    if n_feat > n_cells:
        assert not bool(mk.valid[n_cells:].any()) and float(mk.uv[n_cells:].abs().sum()) == 0.0
    if kind == "coarse":                                    # the tie rules were exercised
        best = pmax.max(0).values
        finite = best[torch.isfinite(best)]
        assert finite.numel() > finite.unique().numel()


WHOLE_CELLS = [3, 5, 6, 10, 12, 24]


def _assert_like_jax(kp, uv, valid, level, score, subpixel):
    """uv, level and valid exact (subpixel positions within 1e-4 px: the
    parabola's small denominators magnify XLA's contracted ulps, the bound
    tests/test_torch_scale_detect.py holds), scores rtol 1e-5 / atol 1e-3."""
    np.testing.assert_array_equal(kp.valid.numpy(), valid)
    np.testing.assert_array_equal(kp.level.numpy(), level)
    if subpixel:
        np.testing.assert_allclose(kp.uv.numpy()[valid], uv[valid], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(np.floor(kp.uv.numpy()[valid]), np.floor(uv[valid]))
    else:
        np.testing.assert_array_equal(kp.uv.numpy(), uv)
    np.testing.assert_allclose(kp.score.numpy(), score, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("cell", WHOLE_CELLS)
@pytest.mark.parametrize("subpixel", [False, True])
def test_whole_cell_tiles_half_sample(cell, subpixel):
    """Kernel A's tiles of whole cells on the half-sample pyramid (level l's
    cell is cell >> l: 24 -> 24, 12, 6, 3), modelled tile by tile, against
    the plain cells, the whole plain detection and the JAX package's
    detect_keypoints (XLA composition on an integer image)."""
    img = _image("integer", (120, 160), seed=cell)
    pt = timg.build_pyramid(torch.from_numpy(img), 4)
    kw = dict(num_features=256, cell_size=cell, fast_threshold=20.0, min_response=20.0,
              min_border=8, subpixel=subpixel)
    model = model_cells(pt, cell, 20.0, 8, subpixel)
    plain = tfast.detect_cells_ref(pt, cell, 20.0, 8, True, subpixel)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    mk = tfast.detect_select_ref(*model[:2], 160 // cell, 256, cell, 20.0,
                                 model[2] if subpixel else None)
    _same(mk, tfast.detect_keypoints_ref(pt, **kw))
    _same(mk, tfast.detect_keypoints(pt, **kw))
    kj = jax.jit(lambda *lv: jfast.detect_keypoints(
        list(lv), 256, cell, 20.0, 20.0, 8, use_pallas=False, subpixel=subpixel))(
            *[jnp.asarray(p.numpy()) for p in pt])
    _assert_like_jax(mk, np.asarray(kj.uv), np.asarray(kj.valid), np.asarray(kj.level),
                     np.asarray(kj.score), subpixel)
    assert int(mk.valid.sum()) > min(256, (120 // cell) * (160 // cell)) // 4


@pytest.mark.parametrize("cell", WHOLE_CELLS)
@pytest.mark.parametrize("subpixel", [False, True])
def test_whole_cell_tiles_scaled(cell, subpixel):
    """Kernel A's x1.2 mode at any cell (cell pixels on every level's own
    grid, tiles of whole cells), modelled, against the plain cells, kernel
    C's plain ranking, the whole plain detection, and JAX's
    detect_keypoints_level on every level."""
    img = _image("integer", (120, 160), seed=50 + cell)
    pyr = timg.build_scaled_pyramid(torch.from_numpy(img), 4, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    quotas = tfast.level_quotas(256, 4, 1.2, cell, shapes)
    model = model_scaled_cells(pyr, quotas, cell, 20.0, 8, subpixel)
    plain = tfast.detect_scaled_cells_ref(pyr, quotas, cell, 20.0, 8, True, subpixel)
    for a, b in zip(model, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    gate = tfast.response_gate(20.0, 20.0, 20.0)
    kp = tfast.detect_scaled_select_ref(*model, shapes, quotas, cell, gate)
    args = (pyr, quotas, cell, 20.0, 20.0, 8, True, 20.0, subpixel)
    _same(kp, tfast.detect_keypoints_scaled_ref(*args))
    _same(kp, tfast.detect_keypoints_scaled(*args))
    parts = [jax.jit(lambda x, q=q: jfast.detect_keypoints_level(
        x, q, cell, 20.0, float(gate), 8, use_pallas=False, subpixel=subpixel))(
            jnp.asarray(p.numpy())) for p, q in zip(pyr, quotas) if q > 0]
    levels = [np.full(q, l, np.int32) for l, q in enumerate(quotas) if q > 0]
    _assert_like_jax(kp, np.concatenate([np.asarray(k.uv) for k in parts]),
                     np.concatenate([np.asarray(k.valid) for k in parts]),
                     np.concatenate(levels),
                     np.concatenate([np.asarray(k.score) for k in parts]), subpixel)
    assert int(kp.valid.sum()) > 10


@pytest.mark.parametrize("n_feat", [64, 500])
def test_select_model_ranks_nan_and_ties_like_plain(n_feat):
    """Injected cell maxima with NaN, -inf and many equal scores: a NaN
    maximum never wins the merge (NaN > x is false), so the ranking never
    sees one; equal scores rank by cell index; a cell with nothing keeps
    u = v = 0 and level 0."""
    rng = np.random.default_rng(5)
    L, cell, grid_cols, n_cells = 3, 8, 16, 12 * 16
    cmax = (rng.integers(0, 12, (L, n_cells)) * 10.0).astype(np.float32)
    cmax[rng.random((L, n_cells)) < 0.3] = -np.inf
    cmax[rng.random((L, n_cells)) < 0.1] = np.nan
    cmax[:, 5] = -np.inf
    cmax[:, 7] = np.nan
    cmax[0, 9], cmax[1, 9], cmax[2, 9] = np.nan, 50.0, np.nan
    carg = np.stack([rng.integers(0, (cell >> l) ** 2, n_cells) for l in range(L)]
                    ).astype(np.int32)
    cmax, carg = torch.from_numpy(cmax), torch.from_numpy(carg)
    mk = model_select(cmax, carg, grid_cols, n_feat, cell, 20.0)
    ref = tfast.detect_select_ref(cmax, carg, grid_cols, n_feat, cell, 20.0)
    _same(mk, ref)
    assert not bool(torch.isnan(ref.score).any())
    k = min(n_feat, n_cells)
    scores = ref.score[:k][ref.valid[:k]]
    assert bool((scores[:-1] >= scores[1:]).all()) and bool((scores > 20.0).all())
    # cell 9 took level 1's 50.0 in spite of the NaN beside it
    a = int(carg[1, 9])
    u9, v9 = float(((9 % grid_cols) * 4 + a % 4) * 2), float(((9 // grid_cols) * 4 + a // 4) * 2)
    hit = (ref.uv[:, 0] == u9) & (ref.uv[:, 1] == v9) & (ref.level == 1) & (ref.score == 50.0)
    if n_feat >= n_cells:                  # every cell has a slot
        assert int(hit.sum()) == 1


def test_detect_keypoints_dispatch_and_wrapper_checks():
    """CPU tensors take the plain version and launch nothing; the fused
    wrapper takes CUDA tensors only and, before it looks at the device,
    checks shapes alone: any cell size and any number of levels reach the
    device check, an image that holds no cell does not."""
    img = torch.from_numpy(_image("integer", (64, 96), 3))
    pyr = timg.build_pyramid(img, 3)
    kw = dict(num_features=64, cell_size=8, fast_threshold=20.0, min_response=20.0,
              min_border=8)
    kernels.reset_launch_counts()
    _same(tfast.detect_keypoints(pyr, **kw), tfast.detect_keypoints_ref(pyr, **kw))
    assert kernels.LAUNCHES["detect_keypoints_fused"] == 0
    assert kernels.LAUNCHES["detect_score_map"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.detect_keypoints_fused(pyr, **kw)
    with pytest.raises(ValueError, match="whole"):
        kernels.detect_keypoints_fused(pyr, **{**kw, "cell_size": 7.5})
    # nine levels of cells of 256 down to 1 pixel: shapes only
    big = torch.zeros((256, 512))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.detect_keypoints_fused(timg.build_pyramid(big, 9), **{**kw, "cell_size": 256})
    with pytest.raises(ValueError, match="no cell"):
        kernels.detect_keypoints_fused(pyr, **{**kw, "cell_size": 128})
    # any cell passes the shape checks and stops at the device check: of 1
    # to 32 pixels in tiles of whole cells, wider ones a block a cell over
    # 32 x 16 sub-tiles
    for cell in (3, 5, 6, 10, 12, 24, 32, 33, 40, 64):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.detect_keypoints_fused(pyr, **{**kw, "cell_size": cell})
    assert kernels.whole_cell_tile(5) == (30, 15) and kernels.whole_cell_tile(24) == (24, 24)
    assert kernels.whole_cell_tile(16) == (32, 16) and kernels.whole_cell_tile(32) == (32, 32)
    assert kernels.whole_cell_tile(33) == (32, 16) and kernels.whole_cell_tile(64) == (32, 16)
    assert kernels.LAUNCHES["detect_keypoints_fused"] == 0
    # levels whose cell has no pixel are not read (the plain version's break)
    assert tfast.used_levels(5, 8) == 4 and tfast.used_levels(3, 16) == 3
    deep = timg.build_pyramid(img, 5)
    _same(tfast.detect_keypoints_ref(deep, **kw), tfast.detect_keypoints_ref(deep[:4], **kw))
