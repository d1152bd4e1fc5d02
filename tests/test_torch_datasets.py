"""Disk datasets of rgbdslam_tpu_torch against rgbdslam_tpu: the port's own
PNG codec against cv2, the association and camera parsers, RGBDDataset.grab
for TUM, ICL and CoRBS directories written here, a freiburg1 (distorted)
frame's feature build, and the port's copy of the native frame pipeline
against the JAX package's.

The port decodes with cv2 where it is installed, else PIL, else io/png.py.
io/png.py is held bit-equal to cv2 on 8-bit grey, 16-bit depth and on
colour files: its grey is libpng's fixed-point luma, which is what cv2's
IMREAD_GRAYSCALE returns (no pixel differs; PIL's convert("L") differs by
one grey level in about half the pixels of a random colour image).
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rgbdslam_tpu  # noqa: F401
from rgbdslam_tpu.config import ExtractorConfig as JExtractorConfig
from rgbdslam_tpu.frontend.frame import build_frame_features as j_build
from rgbdslam_tpu.geometry import camera as jcamera
from rgbdslam_tpu.io import datasets as jdatasets
from rgbdslam_tpu.io.synthetic import SyntheticDataset as JSyntheticDataset
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.config import ExtractorConfig
from rgbdslam_tpu_torch.frontend.frame import build_frame_features as t_build
from rgbdslam_tpu_torch.geometry import camera as tcamera
from rgbdslam_tpu_torch.io import datasets as tdatasets
from rgbdslam_tpu_torch.io import png
from rgbdslam_tpu_torch.io.png import write_png

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers run at once: two intra-op threads per process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth_image(rng, h=48, w=64, scale=1.0):
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0) + rng.normal(0, 8, (h, w))
    return np.clip(base, 0, 255) * scale


def _filter_rows(px: np.ndarray, bpp: int, types) -> np.ndarray:
    """Rows of px (H, W*bpp) uint8 filtered with the PNG filter types
    `types` (H,): (H, 1 + W*bpp) uint8, the filter byte first."""
    x = px.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    forms = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - png._paeth(a, b, c)]) & 255
    types = np.asarray(types)
    rows = forms[types, np.arange(px.shape[0])].astype(np.uint8)
    return np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)


def _filter_types(path):
    with open(path, "rb") as f:
        data = f.read()
    ihdr = next(b for k, b in png._chunks(data) if k == b"IHDR")
    w, h, bits, ctype = struct.unpack(">IIBB", ihdr[:10])
    raw = zlib.decompress(b"".join(b for k, b in png._chunks(data) if k == b"IDAT"))
    bpp = png._CHANNELS[ctype] * bits // 8
    return set(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)[:, 0].tolist())


@pytest.mark.parametrize("kind", ["gray8", "depth16", "rgb", "rgba"])
def test_png_decode_equals_cv2(tmp_path, kind):
    """cv2 writes Sub-filtered rows; the port's decoder returns cv2's
    IMREAD_UNCHANGED samples and its IMREAD_GRAYSCALE grey, bit for bit."""
    rng = np.random.default_rng(0)
    g = _smooth_image(rng).astype(np.uint8)
    img = {"gray8": g,
           "depth16": (_smooth_image(rng) * 200).astype(np.uint16),
           "rgb": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
           "rgba": rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)}[kind]
    p = str(tmp_path / f"{kind}.png")
    cv2.imwrite(p, img)                         # BGR(A) order
    un = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if un.ndim == 3:                            # the port returns RGB(A)
        un = un[..., [2, 1, 0] + ([3] if un.shape[2] == 4 else [])]
    np.testing.assert_array_equal(png.read_png(p), un)
    gray = png.read_gray(p)
    n_diff = int((gray != cv2.imread(p, cv2.IMREAD_GRAYSCALE)).sum())
    assert n_diff == 0, n_diff


@pytest.mark.parametrize("img", ["gray8", "depth16", "rgb"])
def test_png_every_filter_type_round_trips(tmp_path, img):
    """Rows filtered with each of the five filter types in turn, and with
    libpng's adaptive choice (cv2.imwrite given a compression level): cv2
    reads the files back, and the port's decoder (anti-diagonal sweep)
    returns the same samples."""
    rng = np.random.default_rng(1)
    a = {"gray8": _smooth_image(rng, 64, 96).astype(np.uint8),
         "depth16": (_smooth_image(rng, 64, 96) * 250).astype(np.uint16),
         "rgb": np.stack([_smooth_image(rng, 64, 96).astype(np.uint8)] * 3, -1)}[img]
    a = a.copy()
    if img == "rgb":
        a[..., 1] = np.roll(a[..., 1], 3, axis=1)
    p = str(tmp_path / "a.png")
    bits, ctype = (16, 0) if a.dtype == np.uint16 else (8, 2 if a.ndim == 3 else 0)
    px = (a.astype(">u2").view(np.uint8) if bits == 16 else a).reshape(64, -1)
    for adaptive in (False, True):
        if adaptive:                           # cv2 with a compression level set
            cv2.imwrite(p, a[..., ::-1] if img == "rgb" else a,
                        [cv2.IMWRITE_PNG_COMPRESSION, 3])
            assert len(_filter_types(p) - {0, 1, 2}) >= 1
        else:                                  # row r filtered with type r % 5
            raw = _filter_rows(px, px.shape[1] // 96, np.arange(64) % 5)
            png._write(p, struct.pack(">IIBBBBB", 96, 64, bits, ctype, 0, 0, 0), raw)
            assert _filter_types(p) == {0, 1, 2, 3, 4}
        back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if img == "rgb":
            back = back[..., ::-1]
        np.testing.assert_array_equal(back, a)
        np.testing.assert_array_equal(png.read_png(p), a)
    png.write_png(p, a)                         # unfiltered
    assert _filter_types(p) == {0}
    np.testing.assert_array_equal(png.read_png(p), a)


def test_png_rejects_interlaced_and_bad_input(tmp_path):
    p = tmp_path / "i.png"
    png._write(str(p), struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1),      # Adam7
               np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(p))
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "n.png"))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


def test_png_16bit_gray_as_grayscale(tmp_path):
    """A 16-bit grey file read as grey: its high byte, as cv2 returns it."""
    a = (np.arange(48 * 64).reshape(48, 64) * 21).astype(np.uint16)
    p = str(tmp_path / "d.png")
    cv2.imwrite(p, a)
    np.testing.assert_array_equal(png.read_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def test_association_and_camera_parsers(tmp_path):
    p = tmp_path / "associations.txt"
    p.write_text("# comment\n\n1.0 rgb/1.png 1.01 depth/1.png\nbad line\n"
                 "2.5 rgb/2.png 2.49 depth/2.png extra\n")
    assert tdatasets.parse_associations(str(p)) == jdatasets.parse_associations(str(p))
    for name in ("/d/rgbd_dataset_freiburg1_desk", "/d/rgbd_dataset_freiburg2_xyz",
                 "/d/rgbd_dataset_freiburg3_office", "/d/freiburg9", "/d/living_room"):
        tj, tt = jdatasets.detect_tum_camera(name), tdatasets.detect_tum_camera(name)
        assert {f: getattr(tt, f) for f in tj.__dataclass_fields__} == \
            {f: getattr(tj, f) for f in tj.__dataclass_fields__}, name
    assert tcamera.TUM_FR2.depth_factor == 5208.0 and tcamera.TUM_FR1.has_distortion
    for d in ({"fx": 500, "fy": 501, "cx": 320, "cy": 240},
              {"fx": 500.5, "fy": 501, "cx": 320, "cy": 240, "k1": 0.1, "p2": -0.01,
               "depth_factor": 1000, "width": 320, "height": 240}):
        f = tmp_path / "cam.json"
        f.write_text(json.dumps(d))
        cj, ct = jcamera.load_camera(str(f)), tcamera.load_camera(str(f))
        assert {k: getattr(ct, k) for k in cj.__dataclass_fields__} == \
            {k: getattr(cj, k) for k in cj.__dataclass_fields__}
        assert tcamera.camera_from_dict(d) == ct


def _write_dataset(root, name, n=3, colour=False, factor=5000.0):
    """A directory in the TUM layout (grey or colour PNGs, 16-bit depth,
    associations.txt, groundtruth.txt) written with cv2."""
    base = os.path.join(str(root), name)
    os.makedirs(base + "/rgb")
    os.makedirs(base + "/depth")
    rng = np.random.default_rng(2)
    assoc = []
    for i in range(n):
        ts = 1305031102.175304 + i / 30.0
        g = _smooth_image(rng, 480, 640).astype(np.uint8)
        img = np.stack([g, np.roll(g, 5, 1), np.roll(g, 9, 0)], -1) if colour else g
        d = (rng.uniform(0.3, 5.0, (480, 640)) * factor).astype(np.uint16)
        d[rng.uniform(size=d.shape) < 0.05] = 0
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        cv2.imwrite(os.path.join(base, rp), img)
        cv2.imwrite(os.path.join(base, dp), d)
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
    with open(os.path.join(base, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(base, "groundtruth.txt"), "w") as f:
        f.write("# ground truth\n1305031102.1753 0 0 0 0 0 0 1\n")
    return base


@pytest.mark.parametrize("kind,name,colour", [
    ("TUM", "rgbd_dataset_freiburg1_desk", True),
    ("TUM", "rgbd_dataset_freiburg2_xyz", False),
    ("ICL", "living_room_traj0", False),
    ("CORBS", "corbs_desk", True)])
def test_rgbd_dataset_grab_matches(tmp_path, monkeypatch, kind, name, colour):
    base = _write_dataset(tmp_path, name, colour=colour,
                          factor=5208.0 if "freiburg2" in name else 5000.0)
    dj = jdatasets.open_dataset(base, kind=kind)
    decoders = ("cv2", "png") + (() if colour else ("PIL",))
    assert tdatasets.default_decoder() == "cv2"
    for dec in decoders:
        monkeypatch.setattr(tdatasets, "default_decoder", lambda: dec)
        dt = tdatasets.open_dataset(base, kind=kind)
        assert isinstance(dt, tdatasets.RGBDDataset) and dt.decoder == dec
        assert len(dt) == len(dj) == 3 and dt.timestamps == dj.timestamps
        assert {f: getattr(dt.cam, f) for f in dj.cam.__dataclass_fields__} == \
            {f: getattr(dj.cam, f) for f in dj.cam.__dataclass_fields__}
        assert dt.ground_truth_path() == dj.ground_truth_path()
        for i in range(len(dj)):
            tj, gj, zj = dj.grab(i)
            tt, gt, zt = dt.grab(i)
            assert tt == tj
            assert gt.dtype == zt.dtype == np.float32
            np.testing.assert_array_equal(gt, gj, err_msg=dec)
            np.testing.assert_array_equal(zt, zj, err_msg=dec)
    with pytest.raises(ValueError):
        tdatasets.RGBDDataset(base, kind="KITTI")
    with pytest.raises(FileNotFoundError):
        tdatasets.open_dataset(str(tmp_path / "missing"))


def test_native_framepipe_matches_jax(tmp_path):
    from rgbdslam_tpu.native import framepipe as jfp
    from rgbdslam_tpu_torch.native import framepipe as tfp

    if not (jfp.native_available() and tfp.native_available()):
        pytest.skip("native toolchain/libpng unavailable")
    assert tfp.ensure_built().startswith(os.path.dirname(os.path.dirname(tfp.__file__)))
    base = _write_dataset(tmp_path, "rgbd_dataset_freiburg3_x", n=4, colour=True)
    ds = tdatasets.RGBDDataset(base)
    items = [(os.path.join(base, ds.rgb_files[i]), os.path.join(base, ds.depth_files[i]),
              5000.0) for i in range(len(ds))]
    pt = tfp.FramePipe(640, 480, n_workers=2, capacity=2)
    pj = jfp.FramePipe(640, 480, n_workers=2, capacity=2)
    outs = list(zip(pt.stream(items), pj.stream(items)))
    assert [t[2] for t, _ in outs] == list(range(len(items)))
    for (gt, zt, _), (gj, zj, _) in outs:
        np.testing.assert_array_equal(gt, gj)     # the same unrounded float luma
        np.testing.assert_array_equal(zt, zj)
    # depth: the native (v * (1 / factor)) rounds to the Python loader's
    # float32(v) / factor for every 16-bit value
    v = np.arange(65536, dtype=np.float32)
    assert np.array_equal((v.astype(np.float64) * (1.0 / 5000.0)).astype(np.float32),
                          v / 5000.0)
    np.testing.assert_array_equal(outs[0][0][1], ds.grab(0)[2])
    # an interlaced file: the native loader refuses it, as io/png.py does
    p_int = str(tmp_path / "i.png")
    png._write(p_int, struct.pack(">IIBBBBB", 640, 480, 8, 0, 0, 0, 1),
               np.zeros((480, 641), np.uint8))
    with pytest.raises(IOError):
        tfp.decode_png_gray(p_int, 640, 480)


def test_freiburg1_frame_build_matches(tmp_path, monkeypatch):
    """A freiburg1 directory selects the distorted camera; one frame through
    both packages' loaders and feature builds (the first real use of
    undistort_pixels)."""
    base = str(tmp_path / "rgbd_dataset_freiburg1_desk")
    os.makedirs(base + "/rgb")
    os.makedirs(base + "/depth")
    ds = JSyntheticDataset(n_frames=24, cam=jcamera.TUM_FR1, trajectory="sweep")
    ts, g, d = ds.grab(3)
    write_png(os.path.join(base, "rgb/0.png"), np.asarray(g).astype(np.uint8))
    write_png(os.path.join(base, "depth/0.png"),
              np.clip(np.asarray(d) * 5000.0, 0, 65535).astype(np.uint16))
    with open(os.path.join(base, "associations.txt"), "w") as f:
        f.write(f"{ts:.6f} rgb/0.png {ts:.6f} depth/0.png\n")
    monkeypatch.setattr(tdatasets, "default_decoder", lambda: "png")
    dj, dt = jdatasets.open_dataset(base), tdatasets.open_dataset(base)
    assert dt.cam.has_distortion and dt.cam.fx == dj.cam.fx
    _, gj, zj = dj.grab(0)
    _, gt, zt = dt.grab(0)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(zt, zj)
    ex = dict(num_features=1024, num_levels=3, cell_size=16, fast_threshold=20.0)
    fj = j_build(dj.cam, jnp.asarray(gj), jnp.asarray(zj), JExtractorConfig(**ex))
    ft = t_build(dt.cam, torch.from_numpy(gt), torch.from_numpy(zt), ExtractorConfig(**ex))
    t = convert.frame_features_to_numpy(ft)
    j = {k: np.asarray(getattr(fj, k)) for k in t}
    assert j["valid"].sum() > 300
    for k in ("uv", "level", "valid", "has_depth", "smooth", "intensity"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # descriptor bits: a differing bit must be a tie within f32 rounding of
    # the two blurred samples it compares (the blur sums in another order)
    from rgbdslam_tpu_torch.ops import image as image_ops
    from rgbdslam_tpu_torch.ops.orb import _int_pattern

    blurred = image_ops.gaussian_blur(torch.from_numpy(gt), sigma=2.0, radius=3).numpy()
    bits = np.unpackbits((t["desc"] ^ j["desc"]).view(np.uint8), bitorder="little")
    kp, bit = np.nonzero(bits.reshape(len(t["desc"]), 256))
    assert len(kp) <= 4, len(kp)
    pat = _int_pattern()
    for i, b in zip(kp, bit):
        u, v = np.round(t["uv"][i]).astype(int)
        (ax, ay), (bx, by) = pat[b]
        va = blurred[np.clip(v + ay, 0, 479), np.clip(u + ax, 0, 639)]
        vb = blurred[np.clip(v + by, 0, 479), np.clip(u + bx, 0, 639)]
        assert abs(va - vb) <= 1e-4 * max(abs(va), 1.0), (i, b, va, vb)
    # undistortion: 8 fixed-point rounds in f32, which XLA may contract
    # into FMAs; the undistorted points move up to ~20 px from the raw ones
    moved = np.abs(j["uv_undist"] - j["uv"])[j["valid"]].max()
    assert moved > 1.0, moved
    np.testing.assert_allclose(t["uv_undist"], j["uv_undist"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t["xyz"], j["xyz"], rtol=0, atol=1e-5)
