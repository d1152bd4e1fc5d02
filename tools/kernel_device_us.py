"""Device time of K3's scorer alone, of K5 and of the whole half-sample
detection at chip_smoke.py's shapes, next to an empty launch's, on one CUDA
card.

  python tools/kernel_device_us.py [--root DIR] [--reps 20] [--detect-cells 16,6]

Imports `rgbdslam_tpu_torch` from the tree at --root (default: this one),
so one run on a `git archive` copy of an earlier commit and one on this tree
measure the two versions of the same public entries:
`kernels.mahal_hypothesis_scores` (H = 256 hypotheses, N = 1024
correspondences, unbatched and with a batch of 13) and
`kernels.gicp_gn_normal_equations` (N = 1024), on inputs made on the card
from a seed, and `fast.detect_keypoints` (kernels A and B) on the pyramid of
one 640x480 synthetic frame at each cell size of --detect-cells, with the
other extractor defaults (its kernel A is the entry's own kernel). For each
entry it prints, from torch.profiler over --reps
calls, the device ops a call (kernels, fills, copies), their device
microseconds a call and the entry's own kernel's microseconds a launch
(the mean over the launches the tracer recorded), and the back-to-back
milliseconds a call by CUDA events (three rounds of --reps calls). The
empty launch is a kernel with an empty body, built here with nvcc into
the root tree's `rgbdslam_tpu_torch/_build/` and launched through ctypes,
timed the same ways. The card's name and power limit come first; the last
line is one JSON object of every number. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def empty_launcher(build_dir: Path, nvcc: str):
    """A function that launches the empty kernel on the current stream."""
    import torch

    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "empty_launch.cu"
    lib = build_dir / "libempty_launch.so"
    src.write_text(EMPTY_SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(f"empty launch failed with cudaError {err}")
    return launch


def profile_calls(fn, reps: int) -> dict:
    """Device ops of `reps` calls of fn(), by torch.profiler: {name:
    (launches recorded, device microseconds)}. A window with no device
    record is taken again, at most six times."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(6):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            n, t = ops.get(evt.key, (0, 0.0))
            ops[evt.key] = (n + evt.count, t + us)
        if ops:
            return ops
    raise RuntimeError("the profiler recorded no device op in six windows")


def back_to_back_ms(fn, reps: int, rounds: int = 3) -> list:
    """Milliseconds a call of fn() over `reps` calls back to back, by CUDA
    events, for each of `rounds` rounds (three warm-up calls first)."""
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def measure(fn, own: str, reps: int) -> dict:
    """The profiler's and the events' figures of one entry; `own` is a
    substring of its kernel's name."""
    fn()
    ops = profile_calls(fn, reps)
    own_ops = [(n, t) for k, (n, t) in ops.items() if own in k]
    if not own_ops:
        raise RuntimeError(f"no device record of {own}: {sorted(ops)}")
    own_n = sum(n for n, _ in own_ops)
    ms = back_to_back_ms(fn, reps)
    return {
        "device_ops_per_call": sum(n for n, _ in ops.values()) / reps,
        "device_us_per_call": sum(t for _, t in ops.values()) / reps,
        "own_us_per_launch": sum(t for _, t in own_ops) / own_n,
        "own_launches_recorded": own_n, "calls": reps,
        "ops": {k: n for k, (n, _) in ops.items()},
        "back_to_back_ms": ms, "back_to_back_ms_median": statistics.median(ms),
    }


def scorer_inputs(dev, lead):
    """The smoke's shapes: 256 hypotheses near a motion, 1024 points 0.5-4 m
    deep (20 % invalid), Khoshelham covariance diagonals."""
    import torch
    from rgbdslam_tpu_torch.config import RansacConfig
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag

    g = torch.Generator(device=dev).manual_seed(0)
    T_true = se3.exp(0.05 * torch.randn(6, generator=g, device=dev))
    T_h = (se3.exp(0.05 * torch.randn(lead + (256, 6), generator=g, device=dev))
           @ T_true).contiguous()
    p1 = torch.rand(lead + (1024, 3), generator=g, device=dev) * 2 - 1
    p1[..., 2] = 0.5 + 3.5 * torch.rand(lead + (1024,), generator=g, device=dev)
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + 0.005 * torch.randn(lead + (1024, 3), generator=g, device=dev)).contiguous()
    valid = torch.rand(lead + (1024,), generator=g, device=dev) > 0.2
    cfg = RansacConfig()
    return (T_h, p1.contiguous(), p2, _sigma_diag(p1[..., 2], cfg).contiguous(),
            _sigma_diag(p2[..., 2], cfg).contiguous(), valid)


def gicp_inputs(dev):
    """The smoke's K5 shape: 1024 correspondences with surface covariances."""
    import torch
    from rgbdslam_tpu_torch.geometry import se3

    g = torch.Generator(device=dev).manual_seed(0)
    p1 = torch.rand(1024, 3, generator=g, device=dev) * 2 - 1
    p1[:, 2] += 2.5
    T = se3.exp(0.03 * torch.randn(6, generator=g, device=dev))
    p2 = p1 @ T[:3, :3].T + T[:3, 3] + 0.004 * torch.randn(1024, 3, generator=g, device=dev)
    A = 0.02 * torch.randn(1024, 3, 3, generator=g, device=dev)
    C1 = (A @ A.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    B = 0.02 * torch.randn(1024, 3, 3, generator=g, device=dev)
    C2 = (B @ B.transpose(1, 2) + 1e-4 * torch.eye(3, device=dev)).contiguous()
    valid = torch.rand(1024, generator=g, device=dev) > 0.2
    T0 = (se3.exp(0.02 * torch.randn(6, generator=g, device=dev)) @ T).contiguous()
    return T0, p1.contiguous(), p2.contiguous(), C1, C2, valid


def detection_inputs(dev):
    """The pyramid of frame 1 of a 24-frame 640x480 synthetic orbit and the
    extractor defaults."""
    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.ops import image

    ecfg = ExtractorConfig()
    gray = SyntheticDataset(n_frames=24, cam=SYNTHETIC, device=dev).grab(1)[1]
    return image.build_pyramid(gray, ecfg.num_levels), ecfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the tree whose rgbdslam_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=20, help="calls a window and a round")
    ap.add_argument("--detect-cells", default="16,6",
                    help="cell sizes of the detection entries, comma-separated")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_device_us: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from rgbdslam_tpu_torch.ops import _build, fast, kernels

    if not str(Path(kernels.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {kernels.__file__}, not the tree at {root}")
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; root {root}",
          flush=True)
    _build.library()
    dev = torch.device("cuda")
    empty = empty_launcher(_build.BUILD_DIR, _build.nvcc_path())

    sc, sc13, gn = scorer_inputs(dev, ()), scorer_inputs(dev, (13,)), gicp_inputs(dev)
    th = 9.0                           # 3^2, RansacConfig's max_mahalanobis squared
    entries = {
        "empty_launch": (empty, "empty_kernel"),
        "mahal_hypothesis_scores": (
            lambda: kernels.mahal_hypothesis_scores(*sc, th), "mahal"),
        "mahal_hypothesis_scores_b13": (
            lambda: kernels.mahal_hypothesis_scores(*sc13, th), "mahal"),
        "gicp_gn_normal_equations": (
            lambda: kernels.gicp_gn_normal_equations(*gn, 0.07), "gicp_gn_kernel"),
    }
    pyr, ecfg = detection_inputs(dev)
    for cell in (int(c) for c in args.detect_cells.split(",") if c):
        det = (ecfg.num_features, cell, ecfg.fast_threshold, ecfg.min_response,
               ecfg.min_border)
        entries[f"detect_keypoints_cell{cell}"] = (
            lambda det=det: fast.detect_keypoints(pyr, *det), "detect_cells_kernel")
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi,
           "entries": {}}
    for name, (fn, own) in entries.items():
        m = measure(fn, own, args.reps)
        out["entries"][name] = m
        print(f"[us] {name}: {m['own_us_per_launch']:.3f} us a launch of its kernel "
              f"({m['own_launches_recorded']} of {m['calls']} launches recorded); "
              f"{m['device_ops_per_call']:.2f} device ops and "
              f"{m['device_us_per_call']:.3f} device us a call; back to back "
              f"{m['back_to_back_ms_median']:.4f} ms a call (rounds "
              f"{', '.join(f'{x:.4f}' for x in m['back_to_back_ms'])}) ({smi})", flush=True)
    floor = out["entries"]["empty_launch"]["own_us_per_launch"]
    for name in ("mahal_hypothesis_scores", "mahal_hypothesis_scores_b13",
                 "gicp_gn_normal_equations"):
        print(f"[us] {name}: {out['entries'][name]['device_us_per_call'] / floor:.2f} x an "
              f"empty launch's device time", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
