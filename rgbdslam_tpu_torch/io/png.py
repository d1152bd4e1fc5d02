"""PNG read and write on the standard library's zlib and numpy.

The dataset reader uses cv2, else PIL, where they are installed (as the JAX
package does); a host with neither reads the dataset's PNGs with this
module.

Read: 8-bit grey, grey+alpha, RGB and RGBA, and 16-bit grey, every filter
type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), non-interlaced only: an
Adam7 file raises, as the native loader refuses one
(native/framepipe.cpp). `read_gray` converts colour to grey with libpng's
own fixed-point rule for `png_set_rgb_to_gray(0.299, 0.587)`,
(9797 R + 19234 G + 3737 B) >> 15, which is what `cv2.imread(path,
cv2.IMREAD_GRAYSCALE)` returns, bit for bit; PIL's `convert("L")` rounds
another fixed-point form and differs from both by one grey level in about
half the pixels of a random image.

Average and Paeth rows depend on the pixel to their left, and every
filtered row but None and Sub on the row above: a file with such rows is
unfiltered along its anti-diagonals (row + column = const), all rows at
once, H + W numpy steps per image. Files with only None/Sub/Up rows take
one numpy step per row.

Write: 8-bit and 16-bit grey and 8-bit RGB, unfiltered rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}        # colour type -> samples per pixel
# libpng's png_set_rgb_to_gray_fixed(29900, 58700) coefficients (15-bit)
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """raw (H, W, bpp) filtered bytes, ftype (H,) -> (H, W, bpp) uint8."""
    H, W, _ = raw.shape
    if np.any(ftype > 4):
        raise ValueError(f"PNG filter type {int(ftype.max())} is not defined")
    if not np.any(ftype):
        return raw.astype(np.uint8)
    if np.all(ftype <= 2):
        out = np.empty((H, W, bpp), np.uint8)
        prev = np.zeros((W, bpp), np.uint8)
        for r in range(H):
            f = raw[r]
            if ftype[r] == 1:
                row = (np.cumsum(f, axis=0, dtype=np.int64) & 255).astype(np.uint8)
            elif ftype[r] == 2:
                row = f.astype(np.uint8) + prev          # wraps mod 256
            else:
                row = f.astype(np.uint8)
            out[r] = prev = row
        return out
    # anti-diagonal sweep: S[1 + r, 1 + r + x] = pixel (r, x); row 0 and
    # column 0 stay 0, the left of a row's start stays 0
    S = np.zeros((H + 1, H + W + 1, bpp), np.int32)
    rr, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    F = np.zeros((H, H + W, bpp), np.int32)
    F[rr, rr + xx] = raw
    t = ftype.astype(np.int32)[:, None]
    for d in range(H + W - 1):
        lo, hi = max(0, d - W + 1), min(H - 1, d) + 1
        a = S[1 + lo:1 + hi, d]                # left (r, x - 1)
        b = S[lo:hi, d]                        # up (r - 1, x)
        c = S[lo:hi, d - 1] if d > 0 else np.zeros_like(a)   # up-left
        tt = t[lo:hi]
        pred = np.where(tt == 1, a, np.where(tt == 2, b, np.where(
            tt == 3, (a + b) >> 1, np.where(tt == 4, _paeth(a, b, c), 0))))
        S[1 + lo:1 + hi, d + 1] = (F[lo:hi, d] + pred) & 255
    return S[1 + rr, 1 + rr + xx].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image's samples as stored: (H, W) for grey, (H, W, C) otherwise
    (RGB order, alpha last), uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, bits, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or bits not in (8, 16) or (bits == 16 and ctype != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {bits}, colour type {ctype})")
    ch = _CHANNELS[ctype]
    bpp = ch * bits // 8
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: image data has {buf.size} bytes, expected "
                         f"{H * (1 + W * bpp)}")
    rows = buf.reshape(H, 1 + W * bpp)
    px = _unfilter(rows[:, 1:].reshape(H, W, bpp), rows[:, 0], bpp)
    if bits == 16:
        img = (px[..., 0].astype(np.uint16) << 8) | px[..., 1]   # big-endian
        return img
    return px[..., 0] if ch == 1 else px


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grey as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives it:
    alpha dropped, colour through libpng's fixed-point luma, 16-bit grey cut
    to its high byte."""
    img = read_png(path)
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:                      # grey + alpha
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 or uint16 grey image or a (H, W, 3) uint8 RGB
    image, its rows unfiltered."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    if not rgb and (img.ndim != 2 or img.dtype not in (np.uint8, np.uint16)):
        raise ValueError("write_png takes a (H, W) uint8 / uint16 or (H, W, 3) uint8 array")
    H, W = img.shape[:2]
    bits = 8 * img.dtype.itemsize
    px = (img.astype(">u2").view(np.uint8) if bits == 16 else img).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), px], axis=1)
    _write(path, struct.pack(">IIBBBBB", W, H, bits, 2 if rgb else 0, 0, 0, 0), raw)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write(path: str, ihdr: bytes, raw: np.ndarray) -> None:
    """A PNG of one IHDR body and the filtered rows `raw` (filter byte first)."""
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes()))
                + _chunk(b"IEND", b""))
