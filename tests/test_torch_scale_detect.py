"""K1 as the whole x1.2 scale-space detection, and subpixel offsets in the
detection's table, against rgbdslam_tpu.

A CUDA kernel cannot run without a card, so what is held here is the plain
version of each half: kernel A's x1.2 mode (`fast.detect_scaled_cells_ref`:
per level the best corner of each cell of its own grid, the border in the
level's pixels, the parabola offsets at the winners) and kernel C
(`fast.detect_scaled_select_ref`: each level's cells ranked by their ungated
maxima into its quota of slots). Chained, they are held against JAX's
`detect_keypoints_level` on every level of `build_scaled_pyramid`; the
half-sample detection with the offsets of kernel A's table against JAX's
`detect_keypoints(subpixel=True)`; the whole ORB build against JAX's
`_multiscale_detect_describe`. Both packages get the same numpy frames (and
the per-level tests the same level images); the JAX detector runs through
its plain reference (masked_score_map(use_pallas=False), the XLA composition
the JAX package's tests hold the Pallas kernel to).

Tolerances: uv, level and valid exact; scores within f32 rounding (rtol
1e-5, atol 1e-3: the same Shi-Tomasi arithmetic, which XLA contracts in
part into fused multiply-adds; tests/test_torch_detect.py); subpixel
positions within 1e-4 px (the parabola's small denominators magnify those
ulps; tests/test_torch_families_build.py), and within 1e-2 px for an
invalid slot: an x1.2 level's -inf cells keep their first pixel, in the
border where the raw map is nearly flat and a denominator ~1e-3 of the
scores turns those ulps into up to 5e-3 px (measured on this frame; the
valid slots differ by at most 1.5e-5 px). The ORB build reads each
package's own x1.2 pyramid, whose levels differ by ulps (within 2e-6
relative): its keypoints are held exactly on the slots whose integer
positions agree, at least 99 % of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.frontend import frame as jframe
from rgbdslam_tpu.ops import fast as jfast
from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.frontend import frame as tframe
from rgbdslam_tpu_torch.ops import fast, image, kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CELL = 8
BORDER = 16          # max(min_border, brief_patch_size // 2 + 1) of the ORB build
N_SLOTS = 1024       # at 160x120 level 0's quota (436) exceeds its 300 cells, and
                     # levels 3-7 rank every cell, the -inf ones by index


@pytest.fixture(autouse=True, scope="module")
def _jax_detector_through_its_plain_reference():
    """The JAX detector through its plain reference (tests/test_pallas_detect.py
    holds the Pallas kernel to it); the programs traced meanwhile are dropped
    afterwards."""
    orig = jfast.masked_score_map

    def plain(img, fast_threshold, use_fast_gate=True, use_pallas=True):
        return orig(img, fast_threshold, use_fast_gate, use_pallas=False)

    jfast.masked_score_map = plain
    yield
    jfast.masked_score_map = orig
    _jax_level.cache_clear()
    jax.clear_caches()


def _frame(seed: int, flat_cols: int = 0) -> np.ndarray:
    """A textured 160x120 numpy frame: smoothed uniform noise in 0..255, the
    first `flat_cols` columns flat (cells without a corner)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, size=(120, 160)).astype(np.float32)
    img = image.gaussian_blur(torch.from_numpy(img), sigma=1.2, radius=3).numpy()
    img[:, :flat_cols] = 100.0
    return np.ascontiguousarray(img)


@pytest.fixture(scope="module")
def scaled():
    """The port's x1.2 pyramid of a frame with flat columns, its shapes and
    the quotas of N_SLOTS slots."""
    pyr = image.build_scaled_pyramid(torch.from_numpy(_frame(0, flat_cols=24)), 8, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    return pyr, shapes, fast.level_quotas(N_SLOTS, 8, 1.2, CELL, shapes)


@functools.lru_cache(maxsize=None)
def _jax_level(quota: int, fast_gate: bool):
    """JAX's detect_keypoints_level of one level shape, compiled once with
    the threshold and the gate traced: (integer, subpixel) keypoints."""
    def f(img, thr, gate):
        return tuple(jfast.detect_keypoints_level(img, quota, CELL, thr, gate, BORDER,
                                                  use_fast_gate=fast_gate, use_pallas=False,
                                                  subpixel=sub) for sub in (False, True))
    return jax.jit(f)


def _jax_levels(pyr, quotas, thr, gate, fast_gate=True, subpixel=False):
    """JAX's detect_keypoints_level on the port's level images, the slots of
    every level with a positive quota end to end (level = l)."""
    out = {k: [] for k in ("uv", "score", "valid", "level")}
    for lvl, (img, q) in enumerate(zip(pyr, quotas)):
        if q <= 0:
            continue
        kp = _jax_level(q, fast_gate)(jnp.asarray(img.numpy()), jnp.float32(thr),
                                      jnp.float32(gate))[int(subpixel)]
        out["uv"].append(np.asarray(kp.uv))
        out["score"].append(np.asarray(kp.score))
        out["valid"].append(np.asarray(kp.valid))
        out["level"].append(np.full(q, lvl, np.int32))
    return {k: np.concatenate(v) for k, v in out.items()}


def _assert_matches_jax(kp, ref, subpixel=False):
    if subpixel:
        ok = ref["valid"]
        np.testing.assert_allclose(kp.uv.numpy()[ok], ref["uv"][ok], rtol=0, atol=1e-4)
        np.testing.assert_allclose(kp.uv.numpy(), ref["uv"], rtol=0, atol=1e-2)
        np.testing.assert_array_equal(np.floor(kp.uv.numpy()), np.floor(ref["uv"]))
    else:
        np.testing.assert_array_equal(kp.uv.numpy(), ref["uv"])
    np.testing.assert_array_equal(kp.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(kp.level.numpy(), ref["level"])
    np.testing.assert_allclose(kp.score.numpy(), ref["score"], rtol=1e-5, atol=1e-3)


def _chained(pyr, shapes, quotas, thr, gate_thr, fast_gate=True, subpixel=False):
    """The plain kernel A (x1.2 mode) and kernel C, chained; the whole plain
    detection and the CPU dispatch must give the same slots."""
    cells = fast.detect_scaled_cells_ref(pyr, quotas, CELL, thr, BORDER, fast_gate, subpixel)
    kp = fast.detect_scaled_select_ref(*cells, shapes, quotas, CELL,
                                       fast.response_gate(20.0, thr, gate_thr))
    whole = fast.detect_keypoints_scaled(pyr, quotas, CELL, thr, 20.0, BORDER, fast_gate,
                                         gate_thr, subpixel)
    for a, b in zip(kp, whole):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["detect_keypoints_scaled"] == 0
    return kp


@pytest.mark.parametrize("fast_gate", [True, False])
def test_scaled_halves_match_jax_levels(scaled, fast_gate):
    """Kernel A's x1.2 mode and kernel C, plain and chained, against JAX's
    detect_keypoints_level on every level of the x1.2 pyramid (8 levels of
    a 160x120 frame, the quotas of 1024 slots), FAST-gated and in the GFTT
    mode."""
    pyr, shapes, quotas = scaled
    gate_thr = 15.0 if fast_gate else None
    kp = _chained(pyr, shapes, quotas, 15.0, gate_thr, fast_gate)
    ref = _jax_levels(pyr, quotas, 15.0, fast.response_gate(20.0, 15.0, gate_thr), fast_gate)
    _assert_matches_jax(kp, ref)
    assert kp.uv.shape == (N_SLOTS, 2) and int(kp.valid.sum()) > 300
    cell_max = fast.detect_scaled_cells_ref(pyr, quotas, CELL, 15.0, BORDER, fast_gate)[0]
    assert cell_max.shape == (sum((h // CELL) * (w // CELL) for h, w in shapes),)


def test_quota_beyond_cells_ranks_empty_cells_by_index(scaled):
    """A level whose quota exceeds its cells: its -inf cells (the flat
    columns, the border) rank by index and keep their cell's first pixel,
    invalid; the slots past its cells are zero, invalid, of its level."""
    pyr, shapes, quotas = scaled
    n0 = (shapes[0][0] // CELL) * (shapes[0][1] // CELL)
    assert quotas[0] > n0
    kp = _chained(pyr, shapes, quotas, 15.0, 15.0)
    _assert_matches_jax(kp, _jax_levels(pyr, quotas, 15.0, fast.response_gate(20.0, 15.0, 15.0)))
    pad = slice(n0, quotas[0])
    assert not kp.valid[pad].any() and not kp.uv[pad].any() and not kp.score[pad].any()
    assert (kp.level[pad] == 0).all()
    empty = ~kp.valid[:n0]
    assert int(empty.sum()) > 50 and bool(kp.uv[:n0][empty].any())


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_threshold_and_gate(scaled, factor):
    """A float and a 0-dim tensor threshold give the same slots; with the
    FAST gate the response gate scales with the threshold (F6: (thr * thr)
    * K as XLA compiles it), kernel C's plain version against JAX's levels at
    0.5x, 1x and 2x the configured threshold."""
    pyr, shapes, quotas = scaled
    t = 15.0 * factor
    kp = _chained(pyr, shapes, quotas, t, 15.0)
    kt = _chained(pyr, shapes, quotas, torch.tensor(t, dtype=torch.float32), 15.0)
    for a, b in zip(kp, kt):
        assert torch.equal(a, b)
    gate = fast.response_gate(20.0, t, 15.0)
    assert gate == pytest.approx(20.0 * factor ** 2, rel=1e-6)
    _assert_matches_jax(kp, _jax_levels(pyr, quotas, t, gate))
    assert bool((kp.score[kp.valid] > gate).all())


def test_scaled_subpixel_offsets_match_jax(scaled):
    """The offsets of kernel A's table on the x1.2 path against JAX's
    detect_keypoints_level(subpixel=True): every ranked slot (valid or not)
    moves, the padding does not."""
    pyr, shapes, quotas = scaled
    kp = _chained(pyr, shapes, quotas, 15.0, 15.0, subpixel=True)
    gate = fast.response_gate(20.0, 15.0, 15.0)
    _assert_matches_jax(kp, _jax_levels(pyr, quotas, 15.0, gate, subpixel=True), subpixel=True)
    whole = _chained(pyr, shapes, quotas, 15.0, 15.0)
    for f in ("level", "score", "valid"):
        assert torch.equal(getattr(kp, f), getattr(whole, f))
    assert float((kp.uv - whole.uv).abs().max()) <= 0.5
    assert (kp.uv != whole.uv).float().mean() > 0.5


@pytest.mark.parametrize("flat_cols", [0, 100])
def test_half_sample_subpixel_offsets_match_jax(flat_cols):
    """Kernels A and B's plain versions with the offsets of kernel A's table
    (a cell's winner moves by its level's offsets scaled to level 0; a cell
    with no corner by those of pixel (0, 0) of level 0) against JAX's
    detect_keypoints(subpixel=True), with and without flat cells."""
    gray = _frame(3, flat_cols)
    pt = image.build_pyramid(torch.from_numpy(gray), 4)
    kj = jax.jit(lambda *levels: jfast.detect_keypoints(
        list(levels), 256, CELL, 15.0, 20.0, 8, use_pallas=False, subpixel=True))(
            *[jnp.asarray(p.numpy()) for p in pt])
    cells = fast.detect_cells_ref(pt, CELL, 15.0, 8, True, True)
    assert cells[2].shape == (len(cells[0]) * cells[0].shape[1] + 1, 2)
    kp = fast.detect_select_ref(*cells[:2], 160 // CELL, 256, CELL, 20.0, cells[2])
    whole = fast.detect_keypoints(pt, 256, CELL, 15.0, 20.0, 8, subpixel=True)
    for a, b in zip(kp, whole):
        assert torch.equal(a, b)
    ref = {"uv": np.asarray(kj.uv), "valid": np.asarray(kj.valid),
           "level": np.asarray(kj.level), "score": np.asarray(kj.score)}
    _assert_matches_jax(kp, ref, subpixel=True)
    if flat_cols:
        assert int((~kp.valid).sum()) > 20


def test_orb_build_keypoints_match_jax():
    """The whole ORB detection of the build (x1.2 pyramid, quotas, the
    scaled detection, each level's slice described, the slots scaled to
    level 0 by f32(1.2^l)) against JAX's _multiscale_detect_describe at
    160x120 with 512 slots; each package reads its own pyramid."""
    gray = _frame(4)
    cfg_t = ExtractorConfig(num_features=512, cell_size=CELL, fast_threshold=15.0,
                            scale_factor=1.2, num_levels=8)
    cfg_j = JExtractorConfig(num_features=512, cell_size=CELL, fast_threshold=15.0,
                             scale_factor=1.2, num_levels=8)
    kp, desc = tframe._multiscale_detect_describe(torch.from_numpy(gray), cfg_t, 15.0, 15.0,
                                                  True, "orb", "fast_st")
    # the gate as the JAX build computes it (frame.py:103-106), compiled
    kj, dj = jax.jit(lambda g, thr: jframe._multiscale_detect_describe(
        g, cfg_j, thr, cfg_j.min_response * (thr / cfg_j.fast_threshold) ** 2, True, "orb",
        "fast_st"))(jnp.asarray(gray), jnp.float32(15.0))
    uvj = np.asarray(kj.uv)
    np.testing.assert_array_equal(kp.level.numpy(), np.asarray(kj.level))
    same = (kp.uv.numpy() == uvj).all(axis=1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(kp.valid.numpy()[same], np.asarray(kj.valid)[same])
    np.testing.assert_allclose(kp.score.numpy()[same], np.asarray(kj.score)[same],
                               rtol=1e-5, atol=1e-3)
    assert desc.shape == (512, 8) and int(kp.valid.sum()) > 150
    bits = np.unpackbits((desc.numpy().view(np.uint32)[same]
                          ^ np.asarray(dj)[same]).view(np.uint8))
    assert bits.mean() <= 0.001


def test_scaled_dispatch_and_wrapper_checks(scaled):
    """CPU tensors take the plain version and launch nothing; the x1.2
    wrapper takes CUDA tensors only and, before it looks at the device,
    checks shapes alone: any cell (33 too, walked in sub-tiles) and any
    number of levels reach the device check; quotas that do not fit the
    levels, or give no slot, are refused."""
    pyr, shapes, quotas = scaled
    kernels.reset_launch_counts()
    kw = dict(cell_size=CELL, fast_threshold=15.0, min_response=20.0, min_border=BORDER)
    fast.detect_keypoints_scaled(pyr, quotas, **kw)
    assert kernels.LAUNCHES["detect_keypoints_scaled"] == 0
    assert kernels.LAUNCHES["detect_score_map"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        kernels.detect_keypoints_scaled(pyr, quotas, **kw)
    for cell in (12, 33, 64):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.detect_keypoints_scaled(pyr, quotas, **{**kw, "cell_size": cell})
    with pytest.raises(ValueError, match="CUDA"):
        kernels.detect_keypoints_scaled(pyr + pyr[-1:], quotas + [1], **kw)
    with pytest.raises(ValueError, match="quotas"):
        kernels.detect_keypoints_scaled(pyr, quotas[:-1], **kw)
    with pytest.raises(ValueError, match="slot"):
        kernels.detect_keypoints_scaled(pyr, [0] * len(pyr), **kw)
    for cell in (12, 33):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.detect_keypoints_fused(image.build_pyramid(pyr[0], 2), 64, cell, 15.0,
                                           20.0, 8)
    assert kernels.LAUNCHES["detect_keypoints_scaled"] == 0
