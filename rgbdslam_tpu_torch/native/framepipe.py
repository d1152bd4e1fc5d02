"""ctypes bindings and build of the native frame pipeline (framepipe.cpp,
the port's copy of the JAX package's loader).

Compiled at first use (g++ -O2 -shared, libpng) into
`rgbdslam_tpu_torch/_build/`, named by a hash of the source. It is a host
PNG loader, not a device kernel: where the toolchain or libpng is missing,
`native_available()` is False, `build_error()` holds the compiler's
message, and callers use the Python loader (io/datasets.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "framepipe.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_CMD = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIBS = ("-lpng", "-lz")

_lib = None
_error: Optional[str] = None
_lock = threading.Lock()


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CMD + _LIBS).encode())
    return os.path.join(_BUILD_DIR, f"libframepipe-{h.hexdigest()[:16]}.so")


def ensure_built() -> Optional[str]:
    """Compile the shared library if needed; its path, or None when the
    build failed (the message is in `build_error()`)."""
    global _error
    with _lock:
        path = _lib_path()
        if os.path.exists(path):
            return path
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([*_CMD, _SRC, "-o", tmp, *_LIBS], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, path)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            _error = (getattr(e, "stderr", None) or str(e)).strip()
            return None
        return path


def build_error() -> Optional[str]:
    """The compiler's message of a failed build, else None."""
    return _error


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [ctypes.c_int] * 4
    lib.fp_submit.restype = ctypes.c_int
    lib.fp_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_double, ctypes.c_long]
    lib.fp_next.restype = ctypes.c_int
    lib.fp_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long)]
    lib.fp_close.argtypes = [ctypes.c_void_p]
    lib.fp_destroy.argtypes = [ctypes.c_void_p]
    lib.fp_decode_png_gray.restype = ctypes.c_int
    lib.fp_decode_png_gray.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int, ctypes.c_int, ctypes.c_double]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def decode_png_gray(path: str, width: int, height: int, scale: float = 1.0) -> np.ndarray:
    """Synchronous native PNG decode -> float32 [H, W]. scale != 1 selects
    the 16-bit depth path (value * scale)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native framepipe unavailable")
    out = np.empty((height, width), dtype=np.float32)
    ok = lib.fp_decode_png_gray(path.encode(),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                width, height, scale)
    if not ok:
        raise IOError(f"PNG decode failed: {path}")
    return out


class FramePipe:
    """Threaded prefetching RGB-D frame loader (submission-ordered)."""

    def __init__(self, width: int, height: int, n_workers: int = 2, capacity: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native framepipe unavailable")
        self._lib = lib
        self._h = lib.fp_create(n_workers, capacity, width, height)
        self.width = width
        self.height = height

    def submit(self, rgb_path: str, depth_path: str, depth_factor: float, tag: int = 0):
        rc = self._lib.fp_submit(self._h, rgb_path.encode(), depth_path.encode(),
                                 float(depth_factor), int(tag))
        if rc != 0:
            raise RuntimeError("framepipe submit after close")

    def next(self) -> Tuple[np.ndarray, np.ndarray, int]:
        gray = np.empty((self.height, self.width), dtype=np.float32)
        depth = np.empty((self.height, self.width), dtype=np.float32)
        tag = ctypes.c_long(0)
        rc = self._lib.fp_next(self._h,
                               gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               ctypes.byref(tag))
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise IOError("framepipe: frame decode failed")
        return gray, depth, tag.value

    def close(self):
        self._lib.fp_close(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fp_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def stream(self, items: Sequence[Tuple[str, str, float]]) -> Iterator[
            Tuple[np.ndarray, np.ndarray, int]]:
        """Prefetching iterator over (rgb_path, depth_path, depth_factor).
        Submission runs on a feeder thread: submit() blocks on the bounded
        ring once `capacity` frames are in flight, so feeding and consuming
        must overlap."""

        def feed():
            for i, (r, d, f) in enumerate(items):
                self.submit(r, d, f, i)
            self.close()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            for _ in range(len(items)):
                yield self.next()
        finally:
            feeder.join()
