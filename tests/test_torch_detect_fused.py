"""The whole-detection kernels of csrc/detect.cu, modelled step by step in
PyTorch, against the port's plain detection and the JAX package's.

A CUDA kernel cannot run without a card, so what is tested here is its
algorithm: `model_cells` walks the pyramid levels tile by tile (32x16, as
kernel A's blocks do), gates the border in level-0 coordinates and finds each
cell's maximum in two stages, rows of a cell first and then the cell's rows,
each a strict-> scan, which must give the first maximum of the cell in
row-major order; `model_select` merges the levels with strict >, gates by
the response, ranks the cells by counting (cells with a greater score plus
cells with an equal score and a lower index) and writes the padded keypoint
slots, as kernel B does. Both are held exactly against
`fast.detect_cells_ref` / `fast.detect_select_ref` / `detect_keypoints_ref`,
and against `rgbdslam_tpu.ops.fast.detect_keypoints` (XLA composition):
uv, level and valid exact, the score within the tolerance the two packages'
score maps are held to (rtol 1e-5, atol 1e-3, tests/test_torch_detect.py).
"""

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

TW, TH = 32, 16          # kernel A's tile
NEG_INF = float("-inf")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once; a torch process that takes
    every core for its intra-op threads then spends its time waiting for
    them. Two threads per process keep the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def model_cells(pyramid, cell_size, fast_threshold, min_border):
    """Kernel A: per level and 32x16 tile, gated scores, then per cell the
    row stage and the cell stage; a cell is written by the one tile that
    holds it. Returns (cell_max (L, n_cells), cell_arg (L, n_cells) int32)."""
    h0, w0 = pyramid[0].shape
    grid_rows, grid_cols = h0 // cell_size, w0 // cell_size
    levels = pyramid[:tfast.used_levels(len(pyramid), cell_size)]
    cell_max = torch.full((len(levels), grid_rows * grid_cols), float("nan"))
    cell_arg = torch.full((len(levels), grid_rows * grid_cols), -1, dtype=torch.int32)
    written = torch.zeros((len(levels), grid_rows * grid_cols), dtype=torch.int32)
    for lvl, img in enumerate(levels):
        h, w = img.shape
        cell_l = cell_size >> lvl
        assert TW % cell_l == 0 and TH % cell_l == 0
        masked, _ = kernels.detect_score_map_ref(img, fast_threshold)
        hc, wc = grid_rows * cell_l, grid_cols * cell_l
        for y0 in range(0, hc, TH):
            for x0 in range(0, wc, TW):
                tile = torch.full((TH, TW), NEG_INF)
                th_, tw_ = min(TH, h - y0), min(TW, w - x0)
                tile[:th_, :tw_] = masked[y0:y0 + th_, x0:x0 + tw_]
                X = (x0 + torch.arange(TW)) << lvl
                Y = (y0 + torch.arange(TH)) << lvl
                inb = ((X >= min_border) & (X < w0 - min_border))[None, :] \
                    & ((Y >= min_border) & (Y < h0 - min_border))[:, None]
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
                            cell_max[lvl, idx] = best[cyl, cxl]
                            cell_arg[lvl, idx] = int(arg[cyl, cxl])
                            written[lvl, idx] += 1
    assert bool((written == 1).all())        # one writer a cell: no atomics needed
    return cell_max, cell_arg


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
    wrapper takes CUDA tensors only and refuses what its kernels cannot take
    before it looks at the device."""
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
    with pytest.raises(ValueError, match="at most 8"):
        kernels.detect_keypoints_fused([img] * 9, **{**kw, "cell_size": 256})
    with pytest.raises(ValueError, match="cells"):
        kernels.detect_keypoints_fused(pyr, **{**kw, "cell_size": 128})
    assert kernels.LAUNCHES["detect_keypoints_fused"] == 0
    # levels whose cell has no pixel are not read (the plain version's break)
    assert tfast.used_levels(5, 8) == 4 and tfast.used_levels(3, 16) == 3
    deep = timg.build_pyramid(img, 5)
    _same(tfast.detect_keypoints_ref(deep, **kw), tfast.detect_keypoints_ref(deep[:4], **kw))
