"""Build and load the CUDA kernels of csrc/ (one shared library, plain C
interface, bound with ctypes).

The library is compiled by `nvcc` at first use into
`rgbdslam_tpu_torch/_build/`, named by a hash of the sources and flags, so a
changed source rebuilds. Nothing here runs at import time, and nothing falls
back: a missing compiler or a failed build raises.

Flags: sm_90a (Hopper), and `-fmad=false` so that nvcc does not contract
`a*b+c` into FMAs. Each kernel then rounds exactly like its plain PyTorch
version, and integer results computed from floats (keep masks, inlier
counts) agree at thresholds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points: name -> argument types (every one returns cudaError_t as int)
SIGNATURES = {
    # img, h, w, thr (device pointer), fast_gate, out, raw, stream
    "rgbd_detect_score_map": (_P, _I, _I, _P, _I, _P, _P, _P),
    # imgs, hs, ws (host arrays), n_levels, cell_size, grid_rows, grid_cols,
    # thr (device pointer), fast_gate, min_border, min_response, scale_gate,
    # gate_scale, num_features, subpixel, cell_max, cell_arg, cell_off, uv,
    # level, score, valid, stream
    "rgbd_detect_keypoints": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _F, _I, _F, _I, _I,
                              _P, _P, _P, _P, _P, _P, _P, _P),
    # imgs, hs, ws, quotas (host arrays), n_levels, cell_size, thr (device
    # pointer), fast_gate, min_border, min_response, scale_gate, gate_scale,
    # subpixel, cell_max, cell_arg, cell_off, uv, level, score, valid, stream
    "rgbd_detect_scaled": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _F, _I, _F, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P),
    # d1, d2, v1, v2, n, m, batch, batched1, batched2, best_idx, best_dist,
    # second_dist, col_best_row, stream
    "rgbd_hamming_match_2nn": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P),
    # best_idx, best_dist, second_dist, col_best_row, v1, n, m, batch,
    # batched1, ratio, valid_out, stream
    "rgbd_match_gates": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P),
    # T_h, p1, p2, s1, s2, valid, batch, h, n, chunks, group, th, cnt, err, stream
    "rgbd_mahal_hypothesis_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                     _P, _P, _P),
    # p1, p2, w, valid, u, draws, batch, h, n, sample, model, params (host,
    # 11 floats), refine_iters, polish_iters, min_inliers, scratch, stride,
    # T_h, cnt_h, err_h, T, inliers, cnt, rmse, success, stream
    "rgbd_ransac_se3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _L,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # T, p1, p2, C1, C2, valid, n, iters, max_dist, max_dist2, min_matches,
    # reassoc, planes (global scratch or null), out, stream
    "rgbd_gicp_refine_full": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P, _P, _P),
    # T, p1, p2, C1, C2, valid, n, max_dist2, out, stream
    "rgbd_gicp_gn": (_P, _P, _P, _P, _P, _P, _I, _F, _P, _P),
    # X, a, b, Z, weight, n_edges, k, delta, two_delta, delta_sq, H, g, cost,
    # lam, fixed, stream
    "rgbd_pose_graph_normal_equations": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P,
                                         _P, _P, _P),
    # X, sol, fixed, a, b, Z, weight, n_edges, k, delta, two_delta, delta_sq,
    # cost_it, lam, adaptive, Xc, X_out, state_out, stream
    "rgbd_pose_graph_trial": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _I,
                              _P, _P, _P, _P),
}


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(SRC_DIR.glob("*.cu*")):      # the sources and their headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "rgbdslam_tpu_torch/csrc need the CUDA toolkit")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"librgbd_kernels_{source_hash()}.so"


def build(out: Path) -> dict:
    """Compile every csrc/*.cu (in parallel) and link them into `out`.
    Returns {"seconds", "log"}; raises RuntimeError with nvcc's output on
    failure."""
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    obj_dir = BUILD_DIR / f"obj_{out.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    log.append(" ".join(cmd) + "\n" + res.stdout)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout)
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    text = "\n".join(log)
    out.with_suffix(".log").write_text(text)
    return {"seconds": time.perf_counter() - t0, "log": text}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = library_path()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
