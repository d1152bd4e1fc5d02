"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — card name, and its name and power limit from nvidia-smi;
  2. build   — compile the kernels of rgbdslam_tpu_torch/csrc with nvcc;
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               card, at the tracking step's shapes (640x480, 1024 features,
               256 hypotheses, 10 GICP rounds);
  4. slice   — a 48-frame 640x480 synthetic sweep rendered on the card
               (bit-equal to the same frames rendered on the CPU) through
               PipelinedOdometry(device="cuda") with RANSAC seeds 0-4: the
               median ATE < 0.05 m, no failed frame, and launch counts
               proving each kernel ran on the main path;
  5. times   — three rounds of (the pipeline's wall time, then a stage
               loop timed per stage by CUDA events and by the host clock),
               a profile of the device's busy share, and each kernel beside
               its plain version and its bound;
  6. slam    — the 128-frame 640x480 multi-room tour rendered on the card
               through SlamSystem(device="cuda") (keyframes, proximity
               edges, BoW loop closure with the shipped vocabulary, pose-graph
               LM) with RANSAC seeds 0-2: median ATE < 0.05 m, every seed
               closes the revisit of the start (a loop or proximity edge
               from one of the last ten keyframes to one of the first ten),
               at least two seeds close a BoW loop, the graph is consistent,
               few tracking
               failures, launch counts equal to what the run's bookkeeping
               predicts, host synchronisations per frame equal to the
               budget, and where the tour's time goes;
  7. modes   — the same tour through the ring (track_pipelined, seeds 0-2,
               the serial gates) and through double-buffered batches
               (track_batch_dispatch / track_batch_complete, B=8 for seeds
               0-2, B=32 for seed 0: median ATE < 0.05 m, keyframe counts
               within 20 % + 1 of what the scan's gate picks on the serial
               run's poses, the revisit closed; B=8
               run sequentially equal to the double-buffered run), launch
               counts by the formulas, host synchronisations by the budgets
               (none inside a batch dispatch), the batched ADAPTIVE scenario
               on the card, and the ring, batch and serial times;
  8. disk    — the same tour (freiburg3 intrinsics) written as a TUM-format
               directory of PNGs and run through the CLI
               (rgbdslam_tpu_torch.cli: serial full SLAM, --save-map
               --export-ply --export-octomap --export-html --profile): the
               run equals SlamSystem.track on the same frames quantized in
               memory (keyframes, loops, launch counts, poses within 1e-6),
               ATE < 0.05 m against groundtruth.txt with the revisit closed,
               map.npz resumes into a fresh system (store, graph and device
               bank equal, keyframe 0 verifies against itself), the outputs
               exist, the occupancy rebuild equals the CLI's octomap.npz and
               the CPU's stage by stage, and the native loader's frames and
               run equal the Python loader's (or, where it does not build,
               the CLI falls back with a message); loader, run, checkpoint,
               rebuild and export times.
Phase 3 holds every kernel against its plain version: the dense K1, the
whole detection (kernel A against the plain best-per-cell step, kernel B
against the plain merge and selection on kernel A's outputs, the whole
against the whole, all exact, on sweep frames, on tour frames (phase 6), at
320x240 and on integer images, and with the threshold as a device tensor
against the float), K2 and K3's scorer alone and with a batch of
13, the gated matcher against the tensor gates (exact), the fused RANSAC
against the plain one, held apart (kernel A's poses against the plain fit,
its counts against the plain scorer on its own poses, kernel B against the
plain selection and refits on kernel A's outputs, the whole against the
whole, on the first five sweep pairs, on 13 sweep candidates and (phase 6)
on 13 tour candidates), the whole gicp_refine against the plain loop and
gate on those five sweep pairs and (phase 6) on five tour pairs, and K5
(reached through solvers.icp.gicp_normal_equations) against its plain
version and against one round of K4. The kernels that lie on no main path
(dense K1, K3's scorer alone, K5) are driven through their public entries
and counted apart as `launches_off_path`.
Phase 5 counts the device launches of one call with the profiler
(detect_keypoints 2, gicp_refine 1, ransac_se3 at most 4, match_descriptors
at most 2).
The line before the last is the card's name and power limit; the one
before it a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ITERS_TIMING = 20
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS_TIMING, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def paired_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


@contextlib.contextmanager
def plain_versions_forbidden(kernels):
    """Make every plain kernel version raise while the main path runs."""
    from rgbdslam_tpu_torch.ops import fast
    from rgbdslam_tpu_torch.solvers import icp
    from rgbdslam_tpu_torch.solvers import ransac_se3 as ransac_mod

    names = [(kernels, n) for n in (
        "detect_score_map_ref", "hamming_match_2nn_ref", "match_gates_ref", "match_gated_ref",
        "mahal_hypothesis_scores_ref", "gicp_refine_ref",
        "gicp_gn_normal_equations_ref")]
    names += [(fast, n) for n in ("detect_keypoints_ref", "detect_cells_ref",
                                  "detect_select_ref")]
    names += [(icp, "_finish_gicp")]
    names += [(ransac_mod, n) for n in ("ransac_se3_ref", "hypotheses_ref",
                                        "hypothesis_fits_ref", "select_refine_ref")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def forbid(name):
        def f(*a, **k):
            raise AssertionError(f"plain version {name} ran on the CUDA main path")
        return f

    try:
        for mod, n in names:
            setattr(mod, n, forbid(n))
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def ds_cpu_frame(ds, i: int):
    """Frame i of `ds` rendered on the CPU: (gray, depth)."""
    from rgbdslam_tpu_torch.io.synthetic import render_frame

    return render_frame(ds.cam, ds.poses_twc[i], device="cpu")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory rate, and the float32 rate outside the tensor cores. The
# data sheet names no integer ALU rate: K2's XOR/popcount/add operations
# are counted against the float32 rate too, which flatters the card
# (popcounts run at a quarter of that rate), so that bound is a loose one.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the peak rate."""
    t_b = 1e3 * n_bytes / PEAK_BYTES_PER_S
    t_o = 1e3 * n_ops / PEAK_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sync_calls(fn):
    """Synchronising calls torch reports while fn() runs: (count, the first
    message, fn's result)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")   # warns once itself: not counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    return len(msgs), (msgs[0][:80] if msgs else ""), out


def poses_close(aT, pT, T64, p1, atol=5e-5, factor=10.0):
    """Hold kernel A's hypothesis poses aT against the plain fit pT (both
    f32), with the plain fit in float64, T64, as the yardstick. Rotations:
    atol 5e-5 (30 power iterations summed in another order: the bound the
    CPU tests hold between torch and XLA). Translations t = c2 - R c1: that
    bound times (1 + the farthest point's distance), since they carry the
    rotation's error over the centroid's lever arm (~4 m on these scenes).
    A sample of nearly coincident or collinear points leaves its fit
    ill-determined: the moments cancel, and float32 rounding moves the pose
    by far more than 5e-5 in every implementation. For such a hypothesis
    the bound is `factor` times the plain float32 fit's own distance from
    its float64 evaluation, where that is larger; the caller caps how many
    hypotheses may take that bound and holds them by their scores as well.
    Four draws of one slot give a NaN pose in all three (S = 0), which
    scores no inlier. Returns (the mask of hypotheses held to the wider
    bound, the worst difference over its bound)."""
    reach = 1.0 + float(torch.linalg.norm(p1, dim=-1).max())
    scale = torch.ones(4, 4, device=aT.device)
    scale[:3, 3] = reach
    own = (pT.double() - T64).abs().amax((-1, -2), keepdim=True).nan_to_num(0.0)
    tol = torch.clamp_min(factor * own, atol) * scale
    diff = (aT.double() - pT.double()).abs()
    both_nan = torch.isnan(aT) & torch.isnan(pT)
    ratio = torch.where(both_nan, 0.0, diff / tol)
    ratio = torch.where(torch.isnan(ratio), float("inf"), ratio)
    return (factor * own > atol)[..., 0, 0], float(ratio.max())


def device_launches(fn, reps: int = 4) -> int:
    """Kernels, copies and fills the device ran for one fn(), counted by
    torch.profiler over `reps` calls. A window this short sometimes comes
    back without a single device event (the tracer's buffers were not
    flushed); that is no reading, so it is taken again, at most three times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()                                   # first-use set-up stays outside
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(evt.count for evt in prof.key_averages()
                    if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if total:
            check(total % reps == 0, f"{total} device launches over {reps} equal calls")
            return total // reps
    raise AssertionError("the profiler saw no device event in three windows")


# how the profiler names the kernels of csrc/ (a template's name starts with
# its return type)
OWN_KERNEL_PREFIXES = ("(anonymous namespace)::", "void (anonymous namespace)::")


def own_kernel(key: str) -> bool:
    """True for a kernel of csrc/ (PyTorch keeps some of its own in an
    anonymous namespace too, with at::native in their template arguments)."""
    return key.startswith(OWN_KERNEL_PREFIXES) and "at::native" not in key


def device_us_per_launch(fn, repeats: int = 10) -> dict:
    """Device microseconds per launch of each of the port's own kernels
    over `repeats` calls of fn(), from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and own_kernel(evt.key)):
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            out[evt.key.split("(anonymous namespace)::")[1].split("(")[0]] = round(
                dev_us / evt.count, 2)
    return out


def device_rows(prof) -> list:
    """(device microseconds, name, launches) of each kernel, copy and fill
    in a torch.profiler window."""
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue                     # host-side op events repeat their kernels' time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    return rows


def profile_busy(fn, what: str, smi: str) -> None:
    """Log the device's busy share of fn()'s wall time and the ten kernels
    with the most device time, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = 1000 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1000
    if busy_ms <= 0:
        log(f"[times] profiler, {what}: saw no device time")
        return
    log(f"[times] profiler, {what}: wall {window_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f} %), "
        f"{sum(r[2] for r in rows)} kernel launches ({smi})")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[times]   {dev_us / 1000:9.3f} ms  {count:6d}x  {key[:90]}")
    own = {key.split("(anonymous namespace)::")[1].split("(")[0]: round(dev_us / count, 1)
           for dev_us, key, count in rows if own_kernel(key)}
    log(f"[times] profiler, {what}: device microseconds per launch of the port's own "
        f"kernels {json.dumps(own)}")


def near_threshold_points(cloud, k: int, std_mul: float, rel: float = 1e-5) -> torch.Tensor:
    """Valid points of a cloud whose mean k-NN distance lies within `rel` of
    the statistical-outlier threshold, both computed in float64 on the
    cloud's device: where float32 implementations may keep or drop a point
    differently."""
    p = cloud.xyz.detach().double()
    valid = cloud.valid
    d2 = torch.cdist(p, p) ** 2
    d2[~(valid[:, None] & valid[None, :])] = float("inf")
    d2.fill_diagonal_(float("inf"))
    near = torch.topk(d2, k, dim=-1, largest=False).values
    ok = torch.isfinite(near)
    mean_d = torch.where(ok, near.clamp_min(0).sqrt(), 0.0).sum(-1) / ok.sum(-1).clamp_min(1)
    m = mean_d[valid]
    thresh = m.mean() + std_mul * m.std(unbiased=False)
    return valid & ((mean_d - thresh).abs() <= rel * thresh)


def near_face_samples(cloud, origin, res: float, sensor, n_steps: int = 64,
                      rel: float = 1e-5):
    """(ray samples, endpoints) of a world cloud's valid points within
    rel * res of a voxel face, in float64 on the cloud's device: where
    float32 implementations may put a sample in either neighbouring voxel."""
    dev = cloud.xyz.device
    pts = cloud.xyz.detach().double()
    ts = (torch.arange(n_steps, dtype=torch.float64, device=dev) + 0.5) / n_steps
    o = torch.as_tensor(np.asarray(sensor, np.float64), device=dev)
    lo = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    ray = pts[None] * ts[:, None, None] + o[None, None] * (1 - ts[:, None, None])

    def close(p):
        f = (p - lo) / res
        return ((f - f.round()).abs() < rel).any(-1) & cloud.valid

    return int(close(ray).sum()), int(close(pts).sum())


def disk_phase(dev, smi: str, kernels, n: int = 128):
    """Phase 8: a TUM-format sequence from disk through the port's CLI.

    Writes the 640x480 128-frame tour (freiburg3 intrinsics, so that the
    directory name selects the camera it was rendered with) as 8-bit grey and
    16-bit depth PNGs at factor 5000 with associations.txt and
    groundtruth.txt (tools/make_fake_tum.py's layout), runs
    `rgbdslam_tpu_torch.cli.main` on it (serial full SLAM, --save-map
    --export-ply --export-octomap --export-html --profile) and holds it
    against SlamSystem.track on the same frames quantized in memory, the
    checkpoint's resume, the outputs, the occupancy rebuild against the CPU
    and the native loader. Returns the disk run's launch counts."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    import types
    import zlib

    from rgbdslam_tpu_torch import cli
    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam_tpu_torch.device import upload
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.geometry.camera import TUM_FR3
    from rgbdslam_tpu_torch.io import png
    from rgbdslam_tpu_torch.io import trajectory as traj_io
    from rgbdslam_tpu_torch.io.datasets import DECODERS, RGBDDataset, load_depth_raw, load_gray
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.mapping import cloud as cl
    from rgbdslam_tpu_torch.mapping.occupancy import insert_cloud, load_grid
    from rgbdslam_tpu_torch.native import framepipe as fp
    from rgbdslam_tpu_torch.slam import system as system_mod
    from rgbdslam_tpu_torch.utils.serialization import load_map, save_map
    from rgbdslam_tpu_torch.viz.octomap_export import build_occupancy_from_keyframes

    cam = TUM_FR3
    root = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    try:
        # ---- the sequence
        base = os.path.join(root, "rgbd_dataset_freiburg3_smoke")
        os.makedirs(os.path.join(base, "rgb"))
        os.makedirs(os.path.join(base, "depth"))
        tour = SyntheticDataset(n_frames=n, cam=cam, trajectory="tour", device=dev)
        t0 = time.perf_counter()
        assoc, mem = [], []
        for i in range(n):
            ts, g, d = tour.grab(i)
            g8 = g.cpu().numpy().astype(np.uint8)
            d16 = np.clip(d.cpu().numpy() * 5000.0, 0, 65535).astype(np.uint16)
            rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
            png.write_png(os.path.join(base, rp), g8)
            png.write_png(os.path.join(base, dp), d16)
            assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
            # the frame as the loader returns it (f32 / python float)
            mem.append((float(f"{ts:.6f}"), g8.astype(np.float32),
                        d16.astype(np.float32) / cam.depth_factor))
        with open(os.path.join(base, "associations.txt"), "w") as f:
            f.write("\n".join(assoc) + "\n")
        traj_io.save_tum(os.path.join(base, "groundtruth.txt"), tour.timestamps, tour.poses_twc)
        write_s = time.perf_counter() - t0
        log(f"[disk] wrote {n} frames 640x480 (rendered on the card, freiburg3 intrinsics) "
            f"as grey + 16-bit depth PNGs in {write_s:.3f} s")

        # ---- the Python loader with each decoder this machine has (cv2, PIL,
        # the port's own): every frame equals the in-memory quantization
        ds = RGBDDataset(base)
        check(ds.cam == cam, f"the directory name selected {ds.cam}")
        dec_ms = {}
        for dec in DECODERS:
            try:
                __import__({"cv2": "cv2", "PIL": "PIL.Image", "png": "zlib"}[dec])
            except ImportError:
                continue
            t0 = time.perf_counter()
            grabs = [(ds.timestamps[i],
                      load_gray(os.path.join(base, ds.rgb_files[i]), dec),
                      load_depth_raw(os.path.join(base, ds.depth_files[i]), dec)
                      / cam.depth_factor) for i in range(n)]
            dec_ms[dec] = 1000 * (time.perf_counter() - t0) / n
            for (ts_a, g_a, d_a), (ts_b, g_b, d_b) in zip(grabs, mem):
                check(ts_a == ts_b and np.array_equal(g_a, g_b) and np.array_equal(d_a, d_b)
                      and g_a.dtype == d_a.dtype == np.float32,
                      f"the {dec} loader's frame at t={ts_a} differs from the written one")
            del grabs
        py_ms = dec_ms[ds.decoder]
        log(f"[disk] Python loader, ms/frame over {n} frames by decoder (the default "
            f"{ds.decoder}): {json.dumps({k: round(v, 3) for k, v in dec_ms.items()})}, every "
            f"frame equal to the written one (host, {smi})")
        # io/png.py on adaptively filtered files (libpng's per-row choice,
        # Average and Paeth rows among them), as cv2.imwrite writes them when
        # given a compression level
        if "cv2" in dec_ms:
            import cv2

            adapt = {}
            for what, arr in (("grey", mem[0][1].astype(np.uint8)),
                              ("depth", (mem[0][2] * 5000.0).round().astype(np.uint16))):
                pth = os.path.join(root, f"adaptive_{what}.png")
                cv2.imwrite(pth, arr, [cv2.IMWRITE_PNG_COMPRESSION, 3])
                t0 = time.perf_counter()
                for _ in range(5):
                    back = png.read_png(pth)
                ms = 1000 * (time.perf_counter() - t0) / 5
                check(np.array_equal(back, arr), f"adaptive {what} PNG round trip")
                with open(pth, "rb") as f:
                    raw = zlib.decompress(b"".join(b for k, b in png._chunks(f.read())
                                                   if k == b"IDAT"))
                ftypes = np.frombuffer(raw, np.uint8).reshape(arr.shape[0], -1)[:, 0]
                adapt[what] = f"{ms:.3f} ms (filter types {sorted(set(ftypes.tolist()))})"
            log(f"[disk] io/png.py on one 640x480 file that cv2 filtered adaptively: "
                f"grey {adapt['grey']}, depth {adapt['depth']} (host, {smi})")

        def run_cli(argv):
            """cli.main in-process, the plain kernel versions forbidden: (its
            JSON line, its stderr, the SlamSystem it built)."""
            built = []
            orig = system_mod.SlamSystem

            class Recorded(orig):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    built.append(self)

            so, se = io.StringIO(), io.StringIO()
            system_mod.SlamSystem = Recorded
            try:
                with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
                        plain_versions_forbidden(kernels):
                    rc = cli.main(argv)
            finally:
                system_mod.SlamSystem = orig
            check(rc == 0, f"cli.main returned {rc}")
            return (json.loads(so.getvalue().strip().splitlines()[-1]), se.getvalue(),
                    built[0] if built else None)

        # ---- the main path: the CLI on the directory
        out = os.path.join(root, "out")
        argv = ["--dataset", base, "--kind", "TUM", "--frames", str(n), "--loop-interval", "12",
                "--device", str(dev)]
        exports = ["--save-map", "--export-ply", "--export-octomap", "--export-html",
                   "--profile"]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, err, sys_d = run_cli(argv + ["--out-dir", out] + exports)
        cli_s = time.perf_counter() - t0
        launches_disk = dict(kernels.LAUNCHES)
        batched_disk = dict(kernels.BATCHED_LAUNCHES)
        log(f"[disk] cli: {json.dumps(res)}")
        for line in err.strip().splitlines():
            log(f"[disk] cli stderr: {line}")
        K = sys_d.store.count
        revisit = sys_d.graph.edges_spanning(10, K - 10)
        log(f"[disk] cli wall {cli_s:.3f} s; keyframes {K}, loops {sys_d.loops_closed}, "
            f"edges closing the revisit {revisit}; launches {json.dumps(launches_disk)}, "
            f"batched {json.dumps(batched_disk)}")
        check(res["frames"] == n and res["keyframes"] == K and res["loader"] == ds.decoder,
              f"cli result {res}")
        check(res["ate_rmse"] < 0.05 and res["ate_pairs"] == n,
              f"ATE from groundtruth.txt {res['ate_rmse']} m over {res['ate_pairs']} pairs")
        check(len(revisit) >= 1, "the disk run closed the revisit of the start by no edge")

        # ---- the same frames from memory: the same run
        cfg = SlamConfig(extractor=ExtractorConfig(num_features=1024, cell_size=16,
                                                   fast_threshold=20.0),
                         loop=LoopConfig(id_interval=12))
        sys_m = system_mod.SlamSystem(cam, cfg, device=dev)
        sys_m.load_vocabulary(shipped_vocabulary(cfg.detector))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_versions_forbidden(kernels):
            for ts, g, d in mem:
                sys_m.track(ts, g, d)
            sys_m.finish()
        mem_ms = 1000 * (time.perf_counter() - t0) / n
        launches_mem = dict(kernels.LAUNCHES)
        batched_mem = dict(kernels.BATCHED_LAUNCHES)
        p_d, p_m = sys_d.camera_trajectory()[1], sys_m.camera_trajectory()[1]
        gap = float(np.abs(p_d - p_m).max())
        log(f"[disk] memory run: keyframes {sys_m.store.count}, loops {sys_m.loops_closed}, "
            f"edges {sys_m.graph.n_edges} (disk {sys_d.graph.n_edges}); poses max abs diff "
            f"{gap:.3g}; launches equal: {launches_mem == launches_disk}")
        check(sys_m.store.count == K and sys_m.loops_closed == sys_d.loops_closed
              and sys_m.graph.n_edges == sys_d.graph.n_edges, "disk and memory runs differ")
        check(gap <= 1e-6, f"disk and memory poses differ by {gap}")
        check(launches_mem == launches_disk and batched_mem == batched_disk,
              f"launches: memory {launches_mem} {batched_mem}, disk {launches_disk} "
              f"{batched_disk}")

        # ---- resume from map.npz
        map_path = os.path.join(out, "map.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_map(os.path.join(root, "map2.npz"), sys_d)
        save_ms = 1000 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        sys_r = system_mod.SlamSystem(cam, cfg, device=dev)
        load_map(map_path, sys_r)
        torch.cuda.synchronize()
        load_ms = 1000 * (time.perf_counter() - t0)
        E = sys_d.graph.n_edges
        for f in ("desc", "xyz", "obs_valid", "uv", "intensity", "poses_cw", "timestamps"):
            check(np.array_equal(getattr(sys_r.store, f)[:K], getattr(sys_d.store, f)[:K]),
                  f"resumed store.{f} differs")
        for f in ("e_a", "e_b", "e_Z", "e_w"):
            check(np.array_equal(getattr(sys_r.graph, f)[:E], getattr(sys_d.graph, f)[:E]),
                  f"resumed graph.{f} differs")
        check(sys_r.graph.n_edges == E and sys_r.graph.n_vertices == K, "resumed graph size")
        bank = [b[:K].cpu().numpy() for b in sys_r._bank]
        check(np.array_equal(bank[0].view(np.uint32), sys_r.store.desc[:K])
              and np.array_equal(bank[1], sys_r.store.xyz[:K])
              and np.array_equal(bank[2], sys_r.store.obs_valid[:K])
              and np.array_equal(bank[3], sys_d.loop_detector.bow_db[:K]),
              "the resumed device bank differs from the store")
        f0 = types.SimpleNamespace(desc=sys_r._bank[0][0], xyz=sys_r._bank[1][0],
                                   obs_valid=sys_r._bank[2][0])
        _T, ninl0, ok0, nm0 = sys_r._verify_candidates([0], f0)
        log(f"[disk] resume: store, graph and bank equal; keyframe 0 against itself: "
            f"{int(nm0[0])} matches, {int(ninl0[0])} inliers; save_map {save_ms:.1f} ms, "
            f"load_map {load_ms:.1f} ms ({smi})")
        check(bool(ok0[0]) and int(nm0[0]) > 50, f"keyframe 0 verified {int(nm0[0])} matches")

        # ---- the outputs
        for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt", "map.npz",
                     "map_points.ply", "octomap.npz", "octomap_voxels.ply", "map_viewer.html"):
            pth = os.path.join(out, name)
            check(os.path.exists(pth) and os.path.getsize(pth) > 0, f"{name} missing")
        with open(os.path.join(out, "map_points.ply")) as f:
            head = f.read(400)
        n_obs = int(sys_d.store.obs_valid[:K].sum())
        check(f"element vertex {n_obs}\n" in head, f"map_points.ply: {head[:80]!r}, {n_obs} obs")
        check(res["octomap_voxels"] > 0 and res["octomap_keyframes"] == K
              and res["octomap_kf_skipped"] == 0, f"octomap result {res}")
        ts_index = {ts: i for i, (ts, _, _) in enumerate(mem)}
        kf_images = {k: mem[ts_index[float(sys_d.store.timestamps[k])]][1:] for k in range(K)}
        poses = sys_d.store.poses_cw
        kcfg = cfg.keyframe
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = build_occupancy_from_keyframes(cam, kf_images, poses, kcfg, device=dev)
        torch.cuda.synchronize()
        build_ms = 1000 * (time.perf_counter() - t0)
        g_cli = load_grid(os.path.join(out, "octomap.npz"), device=dev)
        same = all(torch.equal(getattr(grid, f), getattr(g_cli, f))
                   for f in ("log_odds", "color_sum", "color_cnt", "origin"))
        check(same, "the card's rebuild differs from the CLI's octomap.npz")

        # the rebuild by stage on the card: cloud, + SOR, + insertion
        Twc = se3.inverse_np(poses[:K]).astype(np.float32)
        up = [(upload(g, dev), upload(d, dev), upload(Twc[k], dev))
              for k, (g, d) in sorted(kf_images.items())]
        vox_kw = dict(max_points=4096, voxel=kcfg.voxel_size)

        def staged(stage):
            z = torch.zeros_like(g_cli.log_odds)
            gr = g_cli._replace(log_odds=z, color_sum=z.clone(), color_cnt=z.clone())
            for g, d, T in up:
                c = cl.voxel_downsample(cl.create_cloud(cam, g, d, kcfg.cloud_stride,
                                                        kcfg.cloud_z_min, kcfg.cloud_z_max),
                                        **vox_kw)
                if stage >= 1:
                    c = cl.statistical_outlier_removal(c, kcfg.sor_neighbors, kcfg.sor_std_mul)
                if stage >= 2:
                    gr = insert_cloud(gr, cl.transform_cloud(c, T), T[:3, 3])
            torch.cuda.synchronize()

        stage_ms = []
        for stage in range(3):
            staged(stage)                                    # warm
            t0 = time.perf_counter()
            staged(stage)
            stage_ms.append(1000 * (time.perf_counter() - t0))
        sor_ms = stage_ms[1] - stage_ms[0]
        log(f"[disk] octomap rebuild of {K} keyframes on the card: {build_ms:.1f} ms "
            f"({build_ms / K:.3f} ms/keyframe, uploads from the host included), equal to "
            f"the CLI's octomap.npz; by stage without uploads: clouds {stage_ms[0]:.1f} ms, "
            f"+ SOR {stage_ms[1]:.1f} ms, + insertion {stage_ms[2]:.1f} ms; the SOR's share "
            f"{100 * sor_ms / stage_ms[2]:.1f} % ({smi})")

        # the card against the CPU, stage by stage, on every tenth keyframe
        sub = list(range(0, K, 10))
        flips = 0
        vox_gap = 0.0
        for k in sub:
            g, d = kf_images[k]
            c_dev = cl.voxel_downsample(cl.create_cloud(cam, upload(g, dev), upload(d, dev),
                                                        kcfg.cloud_stride, kcfg.cloud_z_min,
                                                        kcfg.cloud_z_max), **vox_kw)
            c_cpu = cl.voxel_downsample(cl.create_cloud(cam, torch.from_numpy(g),
                                                        torch.from_numpy(d), kcfg.cloud_stride,
                                                        kcfg.cloud_z_min, kcfg.cloud_z_max),
                                        **vox_kw)
            check(torch.equal(c_dev.valid.cpu(), c_cpu.valid), f"keyframe {k}: voxel sets differ")
            vox_gap = max(vox_gap, float((c_dev.xyz.cpu() - c_cpu.xyz).abs().max()))
            s_dev = cl.statistical_outlier_removal(c_dev, kcfg.sor_neighbors, kcfg.sor_std_mul)
            s_cpu = cl.statistical_outlier_removal(cl.Cloud(*(a.cpu() for a in c_dev)),
                                                   kcfg.sor_neighbors, kcfg.sor_std_mul)
            flip = (s_dev.valid != s_cpu.valid.to(dev))
            near = near_threshold_points(c_dev, kcfg.sor_neighbors, kcfg.sor_std_mul)
            check(not bool((flip & ~near).any()), f"keyframe {k}: SOR keeps differ away from "
                  f"the threshold ({int(flip.sum())} points)")
            flips += int(flip.sum())
        log(f"[disk] card against CPU on keyframes {sub}: voxel clouds equal sets, centroids "
            f"max abs diff {vox_gap:.3g}; SOR keeps differing {flips}")
        check(vox_gap <= 1e-5, f"voxel centroids differ by {vox_gap}")

        # the whole grid: the port's CPU build from the same keyframe images
        # and poses against the card's. A voxel may differ only through a
        # point the SOR may keep or drop (within 1e-5 of its threshold: its
        # ray's 64 samples and its endpoint) or a sample within 1e-5 voxel of
        # a face (two voxels), counted in float64 on the card's clouds
        t0 = time.perf_counter()
        grid_cpu = build_occupancy_from_keyframes(cam, kf_images, poses, kcfg, device="cpu")
        cpu_build_s = time.perf_counter() - t0
        sor_near = ray_near = end_near = 0
        origin = grid.origin.cpu().numpy()
        for i, (g, d, T) in enumerate(up):
            c = cl.voxel_downsample(cl.create_cloud(cam, g, d, kcfg.cloud_stride,
                                                    kcfg.cloud_z_min, kcfg.cloud_z_max),
                                    **vox_kw)
            sor_near += int(near_threshold_points(c, kcfg.sor_neighbors, kcfg.sor_std_mul).sum())
            w = cl.transform_cloud(cl.statistical_outlier_removal(c, kcfg.sor_neighbors,
                                                                  kcfg.sor_std_mul), T)
            r_n, e_n = near_face_samples(w, origin, grid.resolution, Twc[i][:3, 3])
            ray_near += r_n
            end_near += e_n
        lo_diff = int((grid.log_odds.cpu() != grid_cpu.log_odds).sum())
        cnt_same = grid.color_cnt.cpu() == grid_cpu.color_cnt
        cnt_diff = int((~cnt_same).sum())
        cs_dev, cs_cpu = grid.color_sum.cpu()[cnt_same], grid_cpu.color_sum[cnt_same]
        cs_gap = float(((cs_dev - cs_cpu).abs() / (1e-3 + 1e-6 * cs_cpu.abs())).max())
        occ = int((grid_cpu.log_odds > 0).sum())
        log(f"[disk] the whole grid of {K} keyframes, card against the port's CPU build "
            f"({cpu_build_s:.1f} s on the host): {tuple(grid.log_odds.shape)} voxels, "
            f"{occ} occupied; log-odds differ in {lo_diff}, hit counts in {cnt_diff}, colour "
            f"sums within {cs_gap:.3g} of (1e-3 + 1e-6 |sum|); points within 1e-5 of the SOR "
            f"threshold {sor_near}, ray samples within 1e-5 voxel of a face {ray_near}, "
            f"endpoints {end_near}")
        check(torch.equal(grid.origin.cpu(), grid_cpu.origin) and occ > 1000,
              "the CPU grid's bounds or content")
        check(lo_diff <= 2 * (ray_near + end_near) + 65 * sor_near,
              f"{lo_diff} log-odds differ for {ray_near + end_near} near-face samples and "
              f"{sor_near} near-threshold points")
        check(cnt_diff <= 2 * end_near + sor_near,
              f"{cnt_diff} hit counts differ for {end_near} near-face endpoints and "
              f"{sor_near} near-threshold points")
        check(cs_gap <= 1.0, f"colour sums differ by {cs_gap} of their tolerance")

        # ---- the native loader
        if fp.native_available():
            pipe = fp.FramePipe(cam.width, cam.height, n_workers=2, capacity=8)
            items = [(os.path.join(base, ds.rgb_files[i]), os.path.join(base, ds.depth_files[i]),
                      cam.depth_factor) for i in range(n)]
            t0 = time.perf_counter()
            nat = list(pipe.stream(items))
            nat_ms = 1000 * (time.perf_counter() - t0) / n
            for i, (g, d, tag) in enumerate(nat):
                check(tag == i and np.array_equal(g, mem[i][1]) and np.array_equal(d, mem[i][2]),
                      f"native frame {i} differs from the Python loader's")
            res_n, _err, sys_n = run_cli(argv + ["--out-dir", os.path.join(root, "native"),
                                                 "--native-loader"])
            gap_n = float(np.abs(sys_n.camera_trajectory()[1] - p_d).max())
            log(f"[disk] native loader built: {nat_ms:.3f} ms/frame prefetched over {n} frames "
                f"(2 workers), every frame equal to the Python loader's; its run: "
                f"{json.dumps(res_n)}, poses max abs diff to the disk run {gap_n:.3g}")
            check(res_n["loader"] == "native" and res_n["keyframes"] == K
                  and res_n["loops_closed"] == res["loops_closed"] and gap_n <= 1e-6,
                  "the native loader's run differs")
        else:
            log(f"[disk] native loader did not build: {fp.build_error()}")
            res_n, err_n, _ = run_cli(argv + ["--out-dir", os.path.join(root, "native"),
                                              "--native-loader", "--odometry-only",
                                              "--frames", "8"])
            check("native loader unavailable" in err_n and res_n["loader"] == ds.decoder,
                  f"no fallback line from the CLI: {err_n!r}")
            log(f"[disk] the CLI fell back: {err_n.strip().splitlines()[-1]!r}")

        # ---- live export on the card. The tracking thread snapshots host
        # state and a CUDA event; a worker thread writes the files, its device
        # work on a stream of its own. The same 32 frames three times, each
        # timed over the frames before finish(): without live export, with
        # the worker's jobs held (the tracking thread's own share), with the
        # worker running. The first two must make the same host syncs. The
        # held jobs then run inline under the profiler: the worker's host and
        # device time, which bounds what the device can add to the third run.
        n_live = 32

        def live_system(live_dir=None, hold=None):
            sys_x = system_mod.SlamSystem(cam, cfg, device=dev)
            sys_x.load_vocabulary(shipped_vocabulary(cfg.detector))
            if live_dir is not None:
                os.makedirs(live_dir, exist_ok=True)
                sys_x.live_export = (4, live_dir, 0.0)
            if hold is not None:
                sys_x._live_enqueue = lambda snap: hold.append(snap) or True
            return sys_x

        def track_live(sys_x):
            for ts, g, d in mem[:n_live]:
                sys_x.track(ts, g, d)

        def timed_live(sys_x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            track_live(sys_x)
            frame_ms = 1000 * (time.perf_counter() - t0) / n_live
            t0 = time.perf_counter()
            sys_x.finish()
            torch.cuda.synchronize()
            return frame_ms, 1000 * (time.perf_counter() - t0)

        base_ms, base_fin = timed_live(live_system())
        held = []
        sys_h = live_system(os.path.join(root, "held"), hold=held)
        held_ms, held_fin = timed_live(sys_h)
        live_dir = os.path.join(root, "live")
        sys_l = live_system(live_dir)
        live_ms, live_fin = timed_live(sys_l)
        sys_b = live_system()
        n_sync_base = sync_calls(lambda: track_live(sys_b))[0]
        held_sync = []
        sys_s = live_system(os.path.join(root, "held_sync"), hold=held_sync)
        n_sync_held, first_sync, _ = sync_calls(lambda: track_live(sys_s))
        sys_h._live_stream = torch.cuda.Stream(device=dev)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for job in held:
                sys_h._live_write_job(job)
            torch.cuda.synchronize()
            jobs_ms = 1000 * (time.perf_counter() - t0)
        jobs_dev_ms = sum(r[0] for r in device_rows(prof)) / 1000
        live_files = sorted(os.listdir(live_dir))
        log(f"[disk] live export every 4 keyframes over {n_live} frames, the tracking thread's "
            f"ms/frame before finish(): without {base_ms:.3f}, jobs held {held_ms:.3f}, worker "
            f"running {live_ms:.3f}; finish() {base_fin:.1f} / {held_fin:.1f} / {live_fin:.1f} "
            f"ms; host syncs over the frames without {n_sync_base}, jobs held {n_sync_held} "
            f"({len(held_sync)} snapshots); the worker wrote {sys_l.live_exports_written}, "
            f"dropped {sys_l.live_exports_dropped}, errors {sys_l.live_export_errors}, files "
            f"{live_files} ({smi})")
        log(f"[disk] the {len(held)} held jobs inline: host {jobs_ms:.1f} ms, device busy "
            f"{jobs_dev_ms:.3f} ms; the device can explain at most {jobs_dev_ms / n_live:.3f} "
            f"ms/frame of the worker's {live_ms - held_ms:.3f} ms/frame, the worker's host "
            f"time is {jobs_ms / n_live:.3f} ms/frame ({smi})")
        check(n_sync_held == n_sync_base and len(held_sync) >= 2,
              f"live export added host syncs to the tracking thread: {n_sync_held} against "
              f"{n_sync_base} ({first_sync})")
        check(not sys_l.live_export_errors and sys_l.live_exports_written >= 2
              and {"map_viewer.html", "trajectory.png", "overlay.png",
                   "octomap.npz"} <= set(live_files), "live export")
        check(len(load_grid(os.path.join(live_dir, "octomap.npz"),
                            device=dev).log_odds.nonzero()) > 0, "the live octomap is empty")

        def stage_of(name):
            for line in err.splitlines():
                if line.startswith(name + " "):
                    return line.split()[1]
            return "?"

        log(f"[times] disk path: Python loader ({ds.decoder}) {py_ms:.3f} ms/frame; the CLI run "
            f"{1000 * res['wall_s'] / n:.3f} ms/frame (decode and tracking) against the "
            f"memory run's {mem_ms:.3f} ms/frame; save_map {save_ms:.1f} ms, load_map "
            f"{load_ms:.1f} ms; octomap rebuild {build_ms:.1f} ms ({build_ms / K:.3f} "
            f"ms/keyframe, SOR {100 * sor_ms / stage_ms[2]:.1f} %); the CLI's stages (ms/call): "
            f"track {stage_of('track')}, octomap {stage_of('octomap')}, save_map "
            f"{stage_of('save_map')}, PLY {stage_of('export_ply')}, HTML "
            f"{stage_of('export_html')} ({smi})")
        return launches_disk, batched_disk
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from rgbdslam_tpu_torch.config import (ExtractorConfig, LoopConfig, RansacConfig,
                                           SlamConfig)
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.frontend.matcher import (correspondence_weights,
                                                     gather_matched_points,
                                                     match_descriptors, match_frames)
    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.slam.system import SlamSystem
    from rgbdslam_tpu_torch.solvers.icp import _finish_gicp, gicp_normal_equations
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC, Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.ops import _build, fast, image, kernels
    from rgbdslam_tpu_torch.solvers.icp import gicp_refine
    from rgbdslam_tpu_torch.solvers.kabsch import weighted_rigid_transform
    from rgbdslam_tpu_torch.solvers import ransac_se3 as ransac_mod
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag, _take, ransac_se3
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry
    from rgbdslam_tpu_torch.slam.tracking import Tracker, TrackerState

    dev = torch.device(DEVICE)
    # ---------------------------------------------------------------- 1
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; count {torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"[build] {_build.library_path().name} in {build_s:.3f} s")
    log_path = _build.library_path().with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line.lower() and "0 bytes" not in line:
                log(f"[build] ptxas: {line.strip()}")

    # ---------------------------------------------------------------- 3
    cfg = SlamConfig()
    n_frames = 48
    ds = SyntheticDataset(n_frames=n_frames, cam=SYNTHETIC, trajectory="sweep", device=dev)
    t0 = time.perf_counter()
    frames = [ds.grab(i) for i in range(n_frames)]
    torch.cuda.synchronize()
    log(f"[slice] rendered {n_frames} frames 640x480 on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    odo = PipelinedOdometry(SYNTHETIC, cfg, batch=8, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # K1, the dense kernel: four pyramid levels of a rendered frame and of
    # integer images, through its public entry (it lies on no main path:
    # these are its `launches_off_path`)
    thr = cfg.extractor.fast_threshold
    pyr = image.build_pyramid(frames[0][1], cfg.extractor.num_levels)
    ints = [torch.randint(0, 256, p.shape, generator=gen, device=dev).to(torch.float32)
            for p in pyr]
    err, mism_render = 0.0, 0
    kernels.reset_launch_counts()
    for kind, levels in (("rendered", pyr), ("integer", ints)):
        for lvl, img in enumerate(levels):
            with plain_versions_forbidden(kernels):
                km, kr = fast.masked_score_map(img, thr)
            pm, pr = kernels.detect_score_map_ref(img, thr)
            torch.cuda.synchronize()
            torch.testing.assert_close(kr, pr, rtol=1e-5, atol=1e-3)
            kk, pk = torch.isfinite(km), torch.isfinite(pm)
            n_bad = int((kk != pk).sum())
            both = kk & pk
            if both.any():
                torch.testing.assert_close(km[both], pm[both], rtol=1e-5, atol=1e-3)
            err = max(err, float((kr - pr).abs().max()))
            if kind == "integer":
                check(n_bad == 0, f"K1 keep mask differs on integer level {lvl}: {n_bad} px")
                check(int(kk.sum()) > 0, f"K1 found no corner on integer level {lvl}")
            else:
                mism_render += n_bad
            log(f"[kernels] K1 dense {kind} level {lvl} {tuple(img.shape)}: corners "
                f"{int(kk.sum())}, keep-mask mismatches {n_bad}")
    off_path = {"detect_score_map": kernels.LAUNCHES["detect_score_map"]}
    check(off_path["detect_score_map"] == 2 * len(pyr), "dense K1 launches")
    results["detect_score_map"] = dict(max_abs_err=err, keep_mismatch_rendered=mism_render)

    def max_diff(outs_a, outs_b):
        """Largest absolute difference over paired integer or bool outputs."""
        return float(max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                         for a, b in zip(outs_a, outs_b)))

    detect_err = {"n": 0, "score": 0.0, "unequal": 0}

    def check_detect(tag, gray, ecfg):
        """The whole detection on one image, held apart and all exact (the
        same operation order, -fmad=false): kernel A's cell maxima and first
        indices against the plain best-per-cell step, kernel B's keypoints
        against the plain merge and selection on kernel A's outputs, the
        whole against the whole plain version."""
        levels = image.build_pyramid(gray, ecfg.num_levels)
        args = (ecfg.num_features, ecfg.cell_size, ecfg.fast_threshold, ecfg.min_response,
                ecfg.min_border)
        kp, (cmax, carg) = kernels.detect_keypoints_fused(levels, *args)
        pmax, parg = fast.detect_cells_ref(levels, ecfg.cell_size, ecfg.fast_threshold,
                                           ecfg.min_border)
        torch.cuda.synchronize()
        check(cmax.shape == pmax.shape and torch.equal(cmax, pmax),
              f"detection {tag}: kernel A's cell maxima differ from the plain step's")
        check(torch.equal(carg, parg), f"detection {tag}: kernel A's cell arguments differ")
        part = fast.detect_select_ref(cmax, carg, gray.shape[1] // ecfg.cell_size,
                                      ecfg.num_features, ecfg.cell_size, ecfg.min_response)
        whole = fast.detect_keypoints_ref(levels, *args)
        for what, ref in (("kernel B", part), ("whole", whole)):
            for f in ("uv", "level", "score", "valid"):
                a, b = getattr(kp, f), getattr(ref, f)
                check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
                      f"detection {tag}, {what}: {f} differs")
        check(int(kp.valid.sum()) > 50, f"detection {tag}: {int(kp.valid.sum())} keypoints")
        # kernel A reads the threshold from device memory: as a 0-dim tensor
        # (the batched scan's carry) it gives the float's keypoints, also at
        # the threshold one ADAPTIVE step lower
        for t in (ecfg.fast_threshold, 0.7 * ecfg.fast_threshold):
            t_dev = torch.full((), t, dtype=torch.float32, device=dev)
            a = kernels.detect_keypoints_fused(levels, ecfg.num_features, ecfg.cell_size, t,
                                               ecfg.min_response, ecfg.min_border)[0]
            b = kernels.detect_keypoints_fused(levels, ecfg.num_features, ecfg.cell_size, t_dev,
                                               ecfg.min_response, ecfg.min_border)[0]
            for f in ("uv", "level", "score", "valid"):
                check(torch.equal(getattr(a, f), getattr(b, f)),
                      f"detection {tag}: {f} at a device threshold {t} differs from the float's")
        detect_err["n"] += 1
        detect_err["score"] = max(detect_err["score"],
                                  float((kp.score - whole.score).abs().max()))
        detect_err["unequal"] += sum(int((getattr(kp, f) != getattr(whole, f)).sum())
                                     for f in ("uv", "level", "valid"))
        log(f"[kernels] detection {tag} {tuple(gray.shape)}, {len(cmax)} levels, "
            f"{cmax.shape[1]} cells: kernel A's maxima and arguments, kernel B's and the "
            f"whole's uv, level, score, valid all equal, and equal with the threshold as a "
            f"device tensor (t and 0.7 t); {int(kp.valid.sum())} keypoints, "
            f"levels used {sorted(set(kp.level[kp.valid].tolist()))}")

    for i in (0, 23, 40):
        check_detect(f"sweep frame {i}", frames[i][1], cfg.extractor)
    check_detect("integer image", ints[0], cfg.extractor)
    check_detect("four grey values", torch.floor(ints[0] / 64.0) * 64.0, cfg.extractor)
    cam_small = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    ecfg_small = ExtractorConfig(num_levels=3, cell_size=8, fast_threshold=15.0)
    ds_small = SyntheticDataset(n_frames=24, cam=cam_small, trajectory="sweep", device=dev)
    for i in (0, 11):
        check_detect(f"320x240 sweep frame {i}", ds_small.grab(i)[1], ecfg_small)

    # real matched pair of frames 0 and 1 for K2-K4
    f0 = odo.features(frames[0][1], frames[0][2])
    f1 = odo.features(frames[1][1], frames[1][2])
    v1 = f0.obs_valid & (torch.rand(1024, generator=gen, device=dev) > 0.05)
    v2 = f1.obs_valid & (torch.rand(1024, generator=gen, device=dev) > 0.05)
    check(int((~v1).sum()) > 0 and int((~v2).sum()) > 0, "K2 inputs need invalid slots")
    ko = kernels.hamming_match_2nn(f0.desc, f1.desc, v1, v2)
    po = kernels.hamming_match_2nn_ref(f0.desc, f1.desc, v1, v2)
    for a, b, nm in zip(ko, po, ("best_idx", "best_dist", "second_dist", "col_best_row")):
        check(torch.equal(a.to(torch.int64), b.to(torch.int64)), f"K2 {nm} differs")
    results["hamming_match_2nn"] = dict(max_abs_err=max_diff(ko, po))
    log(f"[kernels] K2 1024x1024: all four outputs equal; "
        f"{int((ko[1] < kernels.BIG).sum())} rows with a valid pair")

    def check_gated(tag, d1, d2, w1, w2):
        """The gated matcher against the 2-NN's plain version and the
        tensor gates: idx2, dist and valid exact; a valid match lands on a
        valid train row (an invalid one is BIG away)."""
        kg = kernels.match_gated(d1, d2, w1, w2, cfg.matcher.nn_ratio)
        pg = kernels.match_gated_ref(d1, d2, w1, w2, cfg.matcher.nn_ratio)
        for a, b, nm in zip(kg, pg, ("idx2", "dist", "valid")):
            check(a.shape == b.shape and torch.equal(a.to(torch.int64), b.to(torch.int64)),
                  f"gated matcher {tag}: {nm} differs")
        check(int(kg[2].sum()) > 0, f"gated matcher {tag}: no match survives")
        w2_at = torch.gather(w2.expand(kg[0].shape[:-1] + w2.shape[-1:]), -1, kg[0].long())
        check(bool((w2_at | ~kg[2]).all()), f"gated matcher {tag}: a valid match on an "
              "invalid train row")
        log(f"[kernels] gated matcher {tag}: idx2, dist, valid equal; "
            f"{int(kg[2].sum())} matches survive the gates")
        return max_diff(kg, pg)

    results["match_gated"] = dict(
        max_abs_err=check_gated("1024x1024", f0.desc, f1.desc, v1, v2))

    m = match_frames(f0, f1, cfg.matcher.nn_ratio)
    p1, p2, w, valid = gather_matched_points(f0, f1, m)
    rc = RansacConfig()
    H, S = rc.num_hypotheses, rc.sample_size
    vidx = torch.nonzero(valid)[:, 0]
    check(vidx.numel() >= 20, f"too few matches for K3/K4: {vidx.numel()}")
    idx = vidx[torch.randint(0, vidx.numel(), (H, S), generator=gen, device=dev)]
    T_h = weighted_rigid_transform(p1[idx], p2[idx], w[idx])
    T_h[0] = torch.eye(4, device=dev)
    T_h = T_h.contiguous()
    s1, s2 = _sigma_diag(p1[:, 2], rc), _sigma_diag(p2[:, 2], rc)
    th = rc.max_mahalanobis ** 2
    kc, ke = kernels.mahal_hypothesis_scores(T_h, p1, p2, s1, s2, valid, th)
    pc, pe = kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, th)
    check(torch.equal(kc, pc), "K3 inlier counts differ")
    torch.testing.assert_close(ke, pe, rtol=1e-5, atol=0.0)
    results["mahal_hypothesis_scores"] = dict(max_abs_err=float((ke - pe).abs().max()))
    log(f"[kernels] K3 256x1024: counts equal (max {int(kc.max())}), "
        f"err-sum max abs diff {results['mahal_hypothesis_scores']['max_abs_err']:.3g}")

    fused_err = {}

    def check_fused(tag, key, q1, q2, qw, qv):
        """The fused RANSAC against the plain one on one problem (or one
        batch), held apart. Tolerances: kernel A's poses against the plain
        Horn fit as `poses_close` states them, with at most 3 % of the
        hypotheses ill-determined and each of those scoring within 2
        inliers of the plain fit's pose under the plain scorer (the bound
        the whole RANSAC's inlier count is held to); kernel A's counts exact and
        sums rtol 1e-5 against the plain scorer on kernel A's own poses
        (same operation order, -fmad=false); kernel B against the plain
        selection and refits on kernel A's outputs, and the whole against
        the whole plain version: success equal, inlier count within 2, T21
        rtol 1e-4 / atol 5e-5 (the refits' sums run in another order, so a
        correspondence on the threshold can change sides)."""
        lead = q1.shape[:-2]
        nv = torch.clamp_min(qv.sum(-1), 1)[..., None, None]
        u = torch.rand(lead + (H, S), generator=gen, device=dev)
        draws = torch.minimum(torch.floor(u * nv).to(torch.int64), nv - 1)
        res, (aT, acnt, aerr) = ransac_mod.ransac_se3_cuda(q1, q2, qw, qv, rc, draws=draws)
        pT, pcnt, perr = ransac_mod.hypotheses_ref(q1, q2, qw, qv, rc, draws=draws)
        torch.cuda.synchronize()
        T64 = ransac_mod.hypothesis_fits_ref(q1.double(), q2.double(), qw.double(), qv, H,
                                             draws=draws)
        loose, worst = poses_close(aT, pT, T64, q1)
        check(worst <= 1.0, f"fused RANSAC {tag}: a pose of kernel A is {worst:.3g} times "
              "its tolerance from the plain fit")
        n_loose = int(loose.sum())
        check(n_loose <= 0.03 * loose.numel(), f"fused RANSAC {tag}: {n_loose} of "
              f"{loose.numel()} hypotheses are held to the ill-determined bound")
        d_loose = int(((acnt.long() - pcnt.long()).abs() * loose).max())
        check(d_loose <= 2, f"fused RANSAC {tag}: an ill-determined hypothesis scores "
              f"{d_loose} inliers away from the plain fit's")
        scnt, serr = kernels.mahal_hypothesis_scores_ref(
            aT, q1, q2, _sigma_diag(q1[..., 2], rc), _sigma_diag(q2[..., 2], rc), qv, th)
        check(torch.equal(acnt, scnt), f"fused RANSAC {tag}: kernel A's counts differ from "
              "the plain scorer's on its own poses")
        torch.testing.assert_close(aerr, serr, rtol=1e-5, atol=0.0)
        part = ransac_mod.select_refine_ref(aT, acnt, aerr, q1, q2, qw, qv, rc)
        whole = ransac_mod.select_refine_ref(pT, pcnt, perr, q1, q2, qw, qv, rc)
        for what, ref in (("kernel B", part), ("whole", whole)):
            check(torch.equal(res.success, ref.success), f"fused RANSAC {tag}, {what}: success")
            dn = int((res.num_inliers.long() - ref.num_inliers.long()).abs().max())
            check(dn <= 2, f"fused RANSAC {tag}, {what}: inlier counts differ by {dn}")
            torch.testing.assert_close(res.T21, ref.T21, rtol=1e-4, atol=5e-5)
        # the uniforms become the same draws inside the kernel
        res_u, _ = ransac_mod.ransac_se3_cuda(q1, q2, qw, qv, rc, u=u)
        check(torch.equal(res_u.T21, res.T21)
              and torch.equal(res_u.num_inliers, res.num_inliers),
              f"fused RANSAC {tag}: uniforms and their draws give different results")
        dT = float((res.T21 - whole.T21).abs().max())
        fused_err[key] = max(fused_err.get(key, 0.0), dT)
        log(f"[kernels] fused RANSAC {tag}: kernel A poses max abs diff "
            f"{float((aT - pT).nan_to_num().abs().max()):.3g} ({worst:.3g} of the bound, "
            f"{n_loose} ill-determined hypotheses held to 10 x the plain fit's own f32 "
            f"error and within {d_loose} inliers of the plain fit's score), counts equal (max {int(acnt.max())}), sums "
            f"max abs diff {float((aerr - serr).abs().max()):.3g}; T21 - plain {dT:.3g}, "
            f"inliers {res.num_inliers.flatten().tolist()} vs "
            f"{whole.num_inliers.flatten().tolist()}, success "
            f"{int(res.success.sum())} of {res.success.numel()}")

    # K4 on the first five frame pairs: their depth-patch covariances come
    # out slightly indefinite, where the Pallas kernel's Cholesky gave NaN
    icp = cfg.icp
    k4_err = {"fused": 0.0}

    def check_gicp(tag, args, atol=1e-5):
        """The whole gicp_refine in one launch against the plain loop and
        gate: converged and the number of valid pairs exact, the output
        pose and the loop's final pose rtol 1e-4 / atol 1e-5 (ten rounds
        of f32 sums in another order, amplified by the problem's condition),
        the last round's gated count within 1 (the plain loop gates |r| < d,
        the kernel |r|^2 < d^2, as the Pallas kernel) and cost rtol 1e-3."""
        T0, q1, q2, C1, C2, inl = args
        (kT, kconv, knv), (kfin, kcost, kcnt) = kernels.gicp_refine_fused(
            *args, icp.max_iterations, icp.max_correspondence_dist, icp.min_matches)
        pfin, pcost, pcnt = kernels.gicp_refine_ref(*args, icp.max_iterations,
                                                    icp.max_correspondence_dist)
        pT, pconv, pnv = _finish_gicp(pfin, T0, q1, q2, inl, icp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kT).all()), f"K4 non-finite on {tag}")
        check(bool(kconv) == bool(pconv) and int(knv) == int(pnv),
              f"K4 {tag}: converged {bool(kconv)} / {bool(pconv)}, valid {int(knv)} / {int(pnv)}")
        check(kconv.dtype == torch.bool and knv.dtype == torch.int32, "K4 output types")
        torch.testing.assert_close(kT, pT, rtol=1e-4, atol=atol)
        torch.testing.assert_close(kfin, pfin, rtol=1e-4, atol=atol)
        check(abs(float(kcnt) - float(pcnt)) <= 1.0, f"K4 count {kcnt} vs {pcnt}")
        torch.testing.assert_close(kcost, pcost, rtol=1e-3, atol=1e-6)
        k4_err["fused"] = max(k4_err["fused"], float((kfin - pfin).abs().max()))
        log(f"[kernels] K4 {tag} N={q1.shape[0]} x{icp.max_iterations}: whole gicp_refine "
            f"T max abs diff {float((kT - pT).abs().max()):.3g}, converged {bool(kconv)}, "
            f"{int(knv)} valid pairs, last round's count {float(kcnt)} vs {float(pcnt)}")

    gicp_pairs = []
    fa = f0
    for i in range(1, 6):
        fb = f1 if i == 1 else odo.features(frames[i][1], frames[i][2])
        mk = match_frames(fa, fb, cfg.matcher.nn_ratio)
        q1, q2, qw, qv = gather_matched_points(fa, fb, mk)
        check_fused(f"sweep pair {i}", "ransac_se3_fused", q1, q2, qw, qv)
        res = ransac_se3(q1, q2, qw, qv, gen, rc)
        args = (res.T21, q1, q2, fa.surf_cov, fb.surf_cov[mk.idx2.long()], res.inliers)
        check_gicp(f"sweep pair {i}", args)
        gicp_pairs.append(args)
        fa = fb
    k4_args = gicp_pairs[0]
    results["gicp_refine_fused"] = dict(max_abs_err=k4_err["fused"])
    # fewer valid pairs than min_matches, and a non-finite final pose: both
    # fall back to T_init, in the kernel as in the plain gate
    few = k4_args[5] & (torch.cumsum(k4_args[5].to(torch.int32), 0) <= icp.min_matches - 1)
    p1_inf = k4_args[1].clone()
    p1_inf[int(torch.nonzero(k4_args[5])[0])] = float("inf")
    for tag, args in (("too few pairs", k4_args[:5] + (few,)),
                      ("non-finite pose", (k4_args[0], p1_inf) + k4_args[2:])):
        (kT, kconv, knv), (kfin, _, _) = kernels.gicp_refine_fused(
            *args, icp.max_iterations, icp.max_correspondence_dist, icp.min_matches)
        pfin = kernels.gicp_refine_ref(*args, icp.max_iterations,
                                       icp.max_correspondence_dist)[0]
        pT, pconv, pnv = _finish_gicp(pfin, args[0], args[1], args[2], args[5], icp)
        check(not bool(kconv) and not bool(pconv) and int(knv) == int(pnv)
              and torch.equal(kT, args[0]) and torch.equal(pT, args[0]),
              f"K4 fallback, {tag}")
        check(tag != "non-finite pose" or not bool(torch.isfinite(kfin).all()),
              "K4: the poisoned problem stayed finite")
        log(f"[kernels] K4 {tag}: falls back to T_init like the plain gate "
            f"({int(knv)} valid pairs, final pose finite: {bool(torch.isfinite(kfin).all())})")

    off_path["mahal_hypothesis_scores"] = kernels.LAUNCHES["mahal_hypothesis_scores"]
    check(off_path["mahal_hypothesis_scores"] == 1, "K3's scorer alone: launches")
    # an all-invalid problem: every draw hits slot 0, the fits are the
    # identity, success is false
    none = ransac_se3(p1, p2, torch.zeros_like(w), torch.zeros_like(valid), gen, rc)
    check(not bool(none.success) and int(none.inliers.sum()) == 0
          and torch.equal(none.T21, torch.eye(4, device=dev)),
          "fused RANSAC on an all-invalid problem")

    # K5 on the same five pairs, through its public entry: the launches of
    # this loop are the ones counted for K5 (it lies on no path of the SLAM
    # system); its outputs are then held against the plain version and
    # against one round of K4
    kernels.reset_launch_counts()
    with plain_versions_forbidden(kernels):
        k5_out = [gicp_normal_equations(*a, icp) for a in gicp_pairs]
    torch.cuda.synchronize()
    off_path["gicp_gn_normal_equations"] = kernels.LAUNCHES["gicp_gn_normal_equations"]
    check(off_path["gicp_gn_normal_equations"] == len(gicp_pairs), "K5 launches")
    k5_err = 0.0
    for i, (a, (kH, kb, kcost, kcnt)) in enumerate(zip(gicp_pairs, k5_out), 1):
        pH, pb, pcost, pcnt = kernels.gicp_gn_normal_equations_ref(
            *a, icp.max_correspondence_dist)
        scale = float(pH.abs().max())
        dH, db = float((kH - pH).abs().max()), float((kb - pb).abs().max())
        # 1e-4 of max|H| (the JAX kernel's own test holds 2e-4): on rendered
        # pairs some depth-patch covariances are indefinite, W = S^-1 then
        # has huge entries of both signs that cancel in the sums, and the
        # plain version inverts S in another operation order
        check(dH <= 1e-4 * scale and db <= 1e-4 * scale,
              f"K5 pair {i}: H {dH}, b {db} against max|H| {scale}")
        check(float(kcnt) == float(pcnt), f"K5 pair {i}: count {kcnt} vs {pcnt}")
        torch.testing.assert_close(kcost, pcost, rtol=1e-4, atol=1e-6)
        # one round of K4 = this build, the damped solve, the exp-compose
        xi = torch.linalg.solve(
            kH.double() + 1e-6 * torch.eye(6, device=dev, dtype=torch.float64), -kb.double())
        T_one = (se3.exp(xi) @ a[0].double()).float()
        T_k4, c_k4, n_k4 = kernels.gicp_refine_fused(*a, 1, icp.max_correspondence_dist,
                                                     icp.min_matches)[1]
        d_k4 = float((T_k4 - T_one).abs().max())
        check(d_k4 <= 1e-5, f"K5 pair {i}: exp(solve(H, -b)) T0 differs from K4 by {d_k4}")
        check(float(n_k4) == float(kcnt) and float(c_k4) == float(kcost),
              f"K5 pair {i}: cost/count differ from K4's round")
        k5_err = max(k5_err, dH / scale, db / scale)
        log(f"[kernels] K5 pair {i} N=1024: H, b max abs diff / max|H| {dH / scale:.3g}, "
            f"{db / scale:.3g}; count {float(kcnt)} equal; K4(iters=1) - exp(solve) "
            f"{d_k4:.3g}")
    results["gicp_gn_normal_equations"] = dict(max_abs_err=k5_err)

    # K2 and K3 with the keyframe backend's batch: 13 candidate feature sets
    # (sweep frames 2-14) against frame 1
    cand = [odo.features(frames[i][1], frames[i][2]) for i in range(2, 15)]
    Db = torch.stack([c.desc for c in cand]).contiguous()
    Xb = torch.stack([c.xyz for c in cand]).contiguous()
    Vb = torch.stack([c.obs_valid for c in cand]).contiguous()
    Vb = Vb & (torch.rand(Vb.shape, generator=gen, device=dev) > 0.05)
    kob = kernels.hamming_match_2nn(Db, f1.desc, Vb, v2)
    pob = kernels.hamming_match_2nn_ref(Db, f1.desc, Vb, v2)
    for a, b, nm in zip(kob, pob, ("best_idx", "best_dist", "second_dist", "col_best_row")):
        check(a.shape == b.shape and torch.equal(a.to(torch.int64), b.to(torch.int64)),
              f"batched K2 {nm} differs")
    log(f"[kernels] K2 batched {tuple(Db.shape)} x {tuple(f1.desc.shape)}: all four "
        f"outputs equal; {int((kob[1] < kernels.BIG).sum())} rows with a valid pair")
    results["match_gated_b13"] = dict(max_abs_err=check_gated(
        f"batched {tuple(Db.shape)} x {tuple(f1.desc.shape)}", Db, f1.desc, Vb, v2))
    mb = match_descriptors(Db, Vb, f1.desc, v2, cfg.matcher.nn_ratio)
    jb = mb.idx2.long()
    vb = mb.valid
    p2b = f1.xyz[jb].contiguous()
    wb = correspondence_weights(Xb, p2b, vb)
    pick = torch.randint(0, 1024, (13, H, S), generator=gen, device=dev)
    T_hb = weighted_rigid_transform(_take(Xb, pick), _take(p2b, pick), _take(wb, pick))
    T_hb[:, 0] = torch.eye(4, device=dev)
    T_hb = T_hb.contiguous()
    s1b, s2b = _sigma_diag(Xb[..., 2], rc), _sigma_diag(p2b[..., 2], rc)
    kcb, keb = kernels.mahal_hypothesis_scores(T_hb, Xb, p2b, s1b, s2b, vb, th)
    off_path["mahal_hypothesis_scores_b13"] = kernels.BATCHED_LAUNCHES["mahal_hypothesis_scores"]
    check(off_path["mahal_hypothesis_scores_b13"] == 1, "K3's scorer alone, batched: launches")
    pcb, peb = kernels.mahal_hypothesis_scores_ref(T_hb, Xb, p2b, s1b, s2b, vb, th)
    check(kcb.shape == (13, H) and torch.equal(kcb, pcb), "batched K3 inlier counts differ")
    torch.testing.assert_close(keb, peb, rtol=1e-5, atol=0.0)
    results["hamming_match_2nn_b13"] = dict(max_abs_err=max_diff(kob, pob))
    results["mahal_hypothesis_scores_b13"] = dict(max_abs_err=float((keb - peb).abs().max()))
    log(f"[kernels] K3 batched {tuple(T_hb.shape)}: counts equal (max {int(kcb.max())}), "
        f"err-sum max abs diff {results['mahal_hypothesis_scores_b13']['max_abs_err']:.3g}")
    # the fused RANSAC on the same 13 candidates, two of them emptied
    # (padded candidate slots of the keyframe backend)
    vb2 = vb.clone()
    vb2[3] = False
    vb2[11] = False
    wb2 = correspondence_weights(Xb, p2b, vb2)
    check_fused("13 sweep candidates, two empty", "ransac_se3_fused_b13", Xb, p2b, wb2, vb2)
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 4
    # the card's renderer against the CPU's, on a few frames: the same bits
    for i in (0, 7, 23, 40):
        g_cpu, z_cpu = ds_cpu_frame(ds, i)
        n_g = int((frames[i][1].cpu() != g_cpu).sum())
        n_z = int((frames[i][2].cpu() != z_cpu).sum())
        log(f"[slice] frame {i} rendered on the card vs the CPU: {n_g} gray and "
            f"{n_z} depth pixels differ")
        check(n_g == 0 and n_z == 0, f"card and CPU renders of frame {i} differ")

    # The sweep faces a flat wall, where a RANSAC hypothesis a few cm off can
    # score one inlier more than the true pose with an rmse under the GICP
    # trigger (0.8), so single frames of some seeds keep that error (the
    # reference's behaviour too). One seed decides little either way: the
    # gate is the median ATE over five seeds, and every seed must track
    # every frame.
    seeds = (0, 1, 2, 3, 4)
    odos = [PipelinedOdometry(SYNTHETIC, cfg, batch=8, seed=sd, device=dev) for sd in seeds]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    runs = []
    with plain_versions_forbidden(kernels):
        for sd, o in zip(seeds, odos):
            t0 = time.perf_counter()
            runs.append(o.run(frames) + (time.perf_counter() - t0,))
    launches_sweep = dict(kernels.LAUNCHES)
    ates = []
    for sd, (ts, poses, stats, wall) in zip(seeds, runs):
        rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
        ates.append(rmse)
        log(f"[slice] PipelinedOdometry batch 8, seed {sd}, {n_frames} frames: ATE "
            f"{rmse:.5f} m ({info['pairs']} pairs), failures {stats['failures']}, mean "
            f"inliers {stats['mean_inliers']}, wall {wall:.3f} s")
        check(poses.shape == (n_frames, 4, 4) and np.isfinite(poses).all(), "bad poses")
        check(stats["failures"] == 0, f"seed {sd}: {stats['failures']} failed frames")
    log(f"[slice] launches over the {len(seeds)} runs {json.dumps(launches_sweep)}")
    log(f"[slice] ATE over seeds {list(seeds)}: median {float(np.median(ates)):.5f} m, "
        f"max {max(ates):.5f} m")
    check(float(np.median(ates)) < 0.05,
          f"median ATE over seeds {seeds}: {float(np.median(ates))} m >= 0.05 m")
    pairs = n_frames - 1
    expect = {"detect_score_map": 0,
              "detect_keypoints_fused": n_frames * len(seeds),
              "hamming_match_2nn": pairs * len(seeds),
              "match_gates": pairs * len(seeds),
              "mahal_hypothesis_scores": 0,
              "ransac_se3_fused": pairs * len(seeds),
              "gicp_refine_fused": pairs * len(seeds),
              "gicp_gn_normal_equations": 0}
    check(launches_sweep == expect, f"launch counts {launches_sweep} != {expect}")

    # ---------------------------------------------------------------- 6
    # Serial full SLAM on the multi-room tour: keyframes, proximity edges,
    # BoW loop closure (shipped vocabulary), pose-graph LM. One seed decides
    # little (see the sweep): the gate is the median ATE of three seeds.
    # The tour returns to its start in its last frames, ~0.5 m from the
    # first keyframe, which is the proximity radius: the pair the JAX
    # package closes as a BoW loop is closed here as a proximity edge
    # (and is then no loop candidate), and the one BoW candidate left
    # verifies for most seeds, not for all. So every seed must close the
    # revisit by an edge of either kind, and at least two of the three a
    # BoW loop.
    n_tour = 128
    slam_cfg = SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    tour = SyntheticDataset(n_frames=n_tour, cam=SYNTHETIC, trajectory="tour", device=dev)
    t0 = time.perf_counter()
    tour_frames = [tour.grab(i) for i in range(n_tour)]
    torch.cuda.synchronize()
    log(f"[slam] rendered {n_tour} tour frames 640x480 on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    voc = shipped_vocabulary(slam_cfg.detector)
    check(voc is not None, "the shipped vocabulary is missing")

    # the fused RANSAC on 13 candidates of the tour: frames 0-12 against
    # frame 13, matched as the keyframe backend matches its candidates
    tf = [odo.features(g, z) for _, g, z in tour_frames[:14]]
    tD = torch.stack([c.desc for c in tf[:13]]).contiguous()
    tX = torch.stack([c.xyz for c in tf[:13]]).contiguous()
    tV = torch.stack([c.obs_valid for c in tf[:13]]).contiguous()
    tm = match_descriptors(tD, tV, tf[13].desc, tf[13].obs_valid, cfg.matcher.nn_ratio)
    tp2 = tf[13].xyz[tm.idx2.long()].contiguous()
    check_fused("13 tour candidates", "ransac_se3_fused_b13", tX, tp2,
                correspondence_weights(tX, tp2, tm.valid), tm.valid)
    # the whole detection on tour frames, the whole gicp_refine on tour pairs
    for i in (0, 60, 100):
        check_detect(f"tour frame {i}", tour_frames[i][1], cfg.extractor)
    for i in range(5):
        mk = match_frames(tf[i], tf[i + 1], cfg.matcher.nn_ratio)
        q1, q2, qw, qv = gather_matched_points(tf[i], tf[i + 1], mk)
        res = ransac_se3(q1, q2, qw, qv, gen, rc)
        check_gicp(f"tour pair {i + 1}", (res.T21, q1, q2, tf[i].surf_cov,
                                          tf[i + 1].surf_cov[mk.idx2.long()], res.inliers))
    results["gicp_refine_fused"] = dict(max_abs_err=k4_err["fused"])

    def run_tour(seed, per_frame=None, finish=True, n=n_tour):
        system = SlamSystem(SYNTHETIC, slam_cfg, seed=seed, device=dev)
        system.load_vocabulary(voc)
        ms = []
        for ts, gray, depth in tour_frames[:n]:
            t_f = time.perf_counter()
            if per_frame is None:
                system.track(ts, gray, depth)
            else:
                per_frame(system, ts, gray, depth)
            ms.append(1000 * (time.perf_counter() - t_f))   # track() ends in a device read
        t_f = time.perf_counter()
        if finish:
            system.finish()
        return system, np.array(ms), 1000 * (time.perf_counter() - t_f)

    slam_seeds = (0, 1, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with plain_versions_forbidden(kernels):
        tours = [run_tour(sd) for sd in slam_seeds]
    torch.cuda.synchronize()
    launches_tour = dict(kernels.LAUNCHES)
    batched_tour = dict(kernels.BATCHED_LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    tour_ates, E_all, KF_all, R_all = [], 0, 0, 0
    for sd, (system, ms, finish_ms) in zip(slam_seeds, tours):
        ts_c, poses_c = system.camera_trajectory()
        rmse, info = ate_rmse(ts_c, poses_c, tour.timestamps, tour.poses_twc)
        tour_ates.append(rmse)
        st, K = system.tracker.stats, system.store.count
        log(f"[slam] SlamSystem seed {sd}, {n_tour} frames: ATE {rmse:.5f} m "
            f"({info['pairs']} pairs), keyframes {K}, loops closed {system.loops_closed}, "
            f"graph {system.graph.n_vertices} vertices / {system.graph.n_edges} edges, "
            f"failures {st.failures}, relocalizations {st.relocalizations}, mean inliers "
            f"{st.mean_inliers}, estimates {st.estimates}, wall {ms.sum() / 1000:.3f} s")
        check(poses_c.shape == (n_tour, 4, 4) and np.isfinite(poses_c).all(), "bad poses")
        revisit = system.graph.edges_spanning(10, K - 10)
        log(f"[slam] seed {sd}: edges closing the revisit of the start {revisit}")
        check(len(revisit) >= 1, f"seed {sd} closed the revisit by no edge")
        check(system.graph.n_vertices == K, f"seed {sd}: {system.graph.n_vertices} vertices "
              f"for {K} keyframes")
        check(system.graph.n_edges > system.graph.n_vertices - 1,
              f"seed {sd}: no edge beyond the odometry chain")
        check(st.failures <= 0.15 * n_tour, f"seed {sd}: {st.failures} tracking failures")
        E_all += st.estimates
        KF_all += K
        R_all += system.reloc_verifications
    n_loop_seeds = sum(system.loops_closed >= 1 for system, _, _ in tours)
    check(n_loop_seeds >= 2, f"only {n_loop_seeds} of {len(slam_seeds)} seeds closed a BoW loop")
    log(f"[slam] ATE over seeds {list(slam_seeds)}: median "
        f"{float(np.median(tour_ates)):.5f} m, max {max(tour_ates):.5f} m")
    check(float(np.median(tour_ates)) < 0.05,
          f"median tour ATE over seeds {slam_seeds}: {float(np.median(tour_ates))} m >= 0.05 m")
    # E = match + RANSAC + GICP estimates (one per frame after the first,
    # plus second-reference retries), KF = keyframes (each: one track
    # extension match and one batched verification), R = relocalization
    # verifications
    expect_tour = {
        "detect_score_map": 0,
        "detect_keypoints_fused": n_tour * len(slam_seeds),
        "hamming_match_2nn": E_all + 2 * KF_all + R_all,
        "match_gates": E_all + 2 * KF_all + R_all,
        "mahal_hypothesis_scores": 0,
        "ransac_se3_fused": E_all + KF_all + R_all,
        "gicp_refine_fused": E_all,
        "gicp_gn_normal_equations": 0}
    log(f"[slam] launches over the {len(slam_seeds)} runs {json.dumps(launches_tour)}; "
        f"formula with E={E_all}, KF={KF_all}, R={R_all}: the fused detection = frames x "
        f"seeds, K2 = gates = E + 2 KF + R, fused RANSAC = E + KF + R, the fused gicp_refine "
        f"= E, the dense K1 = K3's scorer alone = K5 = 0 -> "
        f"{json.dumps(expect_tour)}; batched {json.dumps(batched_tour)}")
    check(launches_tour == expect_tour, f"launch counts {launches_tour} != {expect_tour}")
    check(batched_tour == {"hamming_match_2nn": KF_all + R_all, "match_gates": KF_all + R_all,
                           "mahal_hypothesis_scores": 0,
                           "ransac_se3_fused": KF_all + R_all},
          f"batched launches {batched_tour}")
    log(f"[slam] peak device memory over the {len(slam_seeds)} runs "
        f"{peak_mib:.1f} MiB ({smi})")
    for sd, (system, ms, finish_ms) in zip(slam_seeds, tours):
        kf_ms = np.array(system.kf_backend_ms)
        loop_ms = np.array(system.loop_solve_ms)
        log(f"[times] tour seed {sd}: {ms.mean():.3f} ms/frame over {n_tour} frames "
            f"(median {np.median(ms):.3f}); tracking step {(ms.sum() - kf_ms.sum()) / n_tour:.3f} "
            f"ms/frame; keyframe backend {kf_ms.mean():.3f} ms/keyframe x {len(kf_ms)} "
            f"({(kf_ms.sum() - loop_ms.sum()) / n_tour:.3f} ms/frame without the solves); "
            f"loop-closure solves {json.dumps([round(float(x), 1) for x in loop_ms])} ms; "
            f"final optimization {finish_ms:.1f} ms ({smi})")

    # Host synchronisations per frame kind, counted by torch's sync debug
    # mode on one more run. Budget: one read per estimate (the frame's 20
    # floats; a second-reference retry reads again), one per keyframe (the
    # blob), one per loop closure (the solved poses), two per
    # relocalization; the first frame has no estimate.
    kinds = {}

    def counted(system, ts, gray, depth):
        st = system.tracker.stats
        before = (st.estimates, system.store.count, system.loops_closed,
                  system.reloc_verifications)
        n, msg, _ = sync_calls(lambda: system.track(ts, gray, depth))
        dE, dK, dL, dR = (a - b for a, b in zip(
            (st.estimates, system.store.count, system.loops_closed,
             system.reloc_verifications), before))
        budget = dE + dK + dL + 2 * dR
        kind = ("first frame" if before[0] == 0 and dE == 0 else
                "relocalization" if dR else "loop-closing keyframe" if dL else
                ("keyframe" if dK else "plain frame") + (" with retry" if dE > 1 else ""))
        rec = kinds.setdefault(kind, {"frames": 0, "syncs": set(), "budget": set()})
        rec["frames"] += 1
        rec["syncs"].add(n)
        rec["budget"].add(budget)
        check(n == budget, f"{kind} at t={ts:.3f}: {n} synchronisations, budget {budget} "
              f"(estimates {dE}, keyframes {dK}, loops {dL}, relocalizations {dR}); "
              f"first: {msg!r}")

    with plain_versions_forbidden(kernels):
        counted_system, _, _ = run_tour(1, per_frame=counted, finish=False)    # seed 1 closes a loop
    n_fin, msg, _ = sync_calls(counted_system.finish)
    log(f"[times] host-device synchronisations in finish(): {n_fin} ({msg!r})")
    check(n_fin == 1, f"finish() synchronised {n_fin} times, budget 1 (the solved poses)")
    for kind, rec in kinds.items():
        log(f"[times] host-device synchronisations per {kind}: {sorted(rec['syncs'])} "
            f"(budget {sorted(rec['budget'])}) over {rec['frames']} frames")

    # ---------------------------------------------------------------- 7
    # The ring and the batched modes on the same tour, configuration and
    # vocabulary. Each path is driven with the launch counts set to 0 just
    # before it and read just after, the plain versions forbidden.
    def counts(system):
        """(estimates, keyframes, loop closures, relocalization verifications)."""
        st = system.tracker.stats
        return (st.estimates, system.store.count, system.loops_closed,
                system.reloc_verifications)

    def since(system, before):
        return tuple(a - b for a, b in zip(counts(system), before))

    def feed_ring(system, ts, gray, depth):
        system.track_pipelined(ts, gray, depth)

    def run_ring(seed, per_frame=feed_ring, finish=True):
        """(system, ms per track_pipelined call, flush ms, finish ms)."""
        system, ms, _ = run_tour(seed, per_frame=per_frame, finish=False)
        t_f = time.perf_counter()
        system.track_pipelined_flush()               # ends in a device read
        flush_ms = 1000 * (time.perf_counter() - t_f)
        t_f = time.perf_counter()
        if finish:
            system.finish()
        return system, ms, flush_ms, 1000 * (time.perf_counter() - t_f)

    def run_batch(seed, B, double=True, counted=None):
        """(system, wall ms of the tour, finish ms): batches of B, batch i+1
        dispatched before batch i is completed when `double`. With
        `counted`, every dispatch and completion is run under the sync
        debug mode and held to its budget."""
        system = SlamSystem(SYNTHETIC, slam_cfg, seed=seed, device=dev)
        system.load_vocabulary(voc)

        def dispatch(batch):
            if counted is None:
                return system.track_batch_dispatch(*batch)
            n, msg, h = sync_calls(lambda: system.track_batch_dispatch(*batch))
            counted["dispatch"].append(n)
            check(n == 0, f"a batch dispatch synchronised {n} times: {msg!r}")
            return h

        def complete(h):
            if counted is None:
                return system.track_batch_complete(h)
            before = counts(system)
            n, msg, _ = sync_calls(lambda: system.track_batch_complete(h))
            _, dK, dL, dR = since(system, before)
            budget = 1 + int(dK > 0) + dL + 2 * dR
            counted["complete"].append((n, budget))
            check(n == budget, f"a batch completion synchronised {n} times, budget {budget} "
                  f"(keyframes {dK}, loops {dL}, relocalizations {dR}); first: {msg!r}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = None
        for i in range(0, n_tour, B):
            h = dispatch(tuple(zip(*tour_frames[i:i + B])))
            if not double:
                complete(h)
                continue
            if pending is not None:
                complete(pending)
            pending = h
        if pending is not None:
            complete(pending)                        # ends in a device read
        wall_ms = 1000 * (time.perf_counter() - t0)
        t_f = time.perf_counter()
        system.finish()
        return system, wall_ms, 1000 * (time.perf_counter() - t_f)

    serial = {sd: system for sd, (system, _, _) in zip(slam_seeds, tours)}
    serial_poses = {sd: system.camera_trajectory()[1] for sd, system in serial.items()}

    def tour_gates(tag, system):
        """ATE, keyframes, loops and the revisit of the start for one run;
        the graph consistent, every frame on the trajectory."""
        ts_c, poses_c = system.camera_trajectory()
        rmse, info = ate_rmse(ts_c, poses_c, tour.timestamps, tour.poses_twc)
        K, st = system.store.count, system.tracker.stats
        revisit = system.graph.edges_spanning(10, K - 10)
        check(poses_c.shape == (n_tour, 4, 4) and np.isfinite(poses_c).all(),
              f"{tag}: bad poses")
        check(system.graph.n_vertices == K, f"{tag}: {system.graph.n_vertices} vertices "
              f"for {K} keyframes")
        check(len(system.kf_backend_ms) == K, f"{tag}: {len(system.kf_backend_ms)} backend "
              f"times for {K} keyframes")
        check(len(revisit) >= 1, f"{tag} closed the revisit by no edge")
        check(st.failures <= 0.15 * n_tour, f"{tag}: {st.failures} tracking failures")
        return rmse, poses_c, revisit

    # the ring: the serial gates
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with plain_versions_forbidden(kernels):
        rings = [run_ring(sd) for sd in slam_seeds]
    torch.cuda.synchronize()
    launches_ring = dict(kernels.LAUNCHES)
    batched_ring = dict(kernels.BATCHED_LAUNCHES)
    ring_ates, E_all, KF_all, R_all = [], 0, 0, 0
    for sd, (system, ms, flush_ms, finish_ms) in zip(slam_seeds, rings):
        rmse, poses_c, revisit = tour_gates(f"ring seed {sd}", system)
        ring_ates.append(rmse)
        st = system.tracker.stats
        gap = float(np.linalg.norm(poses_c[:, :3, 3] - serial_poses[sd][:, :3, 3], axis=-1).max())
        log(f"[modes] ring seed {sd}, {n_tour} frames: ATE {rmse:.5f} m, keyframes "
            f"{system.store.count}, loops closed {system.loops_closed}, graph "
            f"{system.graph.n_vertices} / {system.graph.n_edges} edges, failures {st.failures}, "
            f"estimates {st.estimates}, revisit {revisit}, largest position gap to the serial "
            f"run {gap:.5f} m")
        E_all += st.estimates
        KF_all += system.store.count
        R_all += system.reloc_verifications
    n_loop_seeds = sum(system.loops_closed >= 1 for system, *_ in rings)
    check(n_loop_seeds >= 2, f"ring: only {n_loop_seeds} of {len(slam_seeds)} seeds closed a "
          "BoW loop")
    check(float(np.median(ring_ates)) < 0.05,
          f"ring: median tour ATE {float(np.median(ring_ates))} m >= 0.05 m")
    expect_ring = dict(expect_tour, **{
        "detect_keypoints_fused": n_tour * len(slam_seeds),
        "hamming_match_2nn": E_all + 2 * KF_all + R_all,
        "match_gates": E_all + 2 * KF_all + R_all,
        "ransac_se3_fused": E_all + KF_all + R_all, "gicp_refine_fused": E_all})
    log(f"[modes] ring: ATE median {float(np.median(ring_ates)):.5f} m; launches "
        f"{json.dumps(launches_ring)}; the serial formula with E={E_all}, KF={KF_all}, "
        f"R={R_all} -> {json.dumps(expect_ring)}; batched {json.dumps(batched_ring)}")
    check(launches_ring == expect_ring, f"ring launch counts {launches_ring} != {expect_ring}")
    check(batched_ring == {"hamming_match_2nn": KF_all + R_all, "match_gates": KF_all + R_all,
                           "mahal_hypothesis_scores": 0, "ransac_se3_fused": KF_all + R_all},
          f"ring batched launches {batched_ring}")

    def device_rule_keyframes(system):
        """The keyframes the batched scan's gate would pick on a run's
        tracked poses: motion since the last keyframe D = Tcw_cur Twc_kf,
        beyond min_translation or min_rotation. The serial (and ring) host
        gate measures inverse(Tcw_cur) Tcw_kf instead, as the JAX package's
        does: its translation adds the rotation since the keyframe times the
        keyframe's distance from the world origin, so on this tour (up to
        4.2 m out) it picks ~117 keyframes where the motion itself picks
        ~84, in both packages. A batch is held to this count."""
        kf_cfg = slam_cfg.keyframe
        traj = system.tracker.trajectory
        last, n = traj[0].Tcw, 1
        for fr in traj[1:]:
            D = fr.Tcw @ se3.inverse_np(last)
            rn = np.arccos(np.clip(0.5 * (np.trace(D[:3, :3]) - 1.0), -1.0, 1.0))
            if np.linalg.norm(D[:3, 3]) > kf_cfg.min_translation or rn > kf_cfg.min_rotation:
                n, last = n + 1, fr.Tcw
        return n

    # double-buffered batches: B=8 for seeds 0-2, B=32 for seed 0, and B=8
    # for seed 0 once more completed batch by batch
    batch_runs = [(8, sd) for sd in slam_seeds] + [(32, 0)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with plain_versions_forbidden(kernels):
        batches = [run_batch(sd, B) for B, sd in batch_runs]
        seq_system, _, _ = run_batch(0, 8, double=False)
    torch.cuda.synchronize()
    launches_batch = dict(kernels.LAUNCHES)
    batched_batch = dict(kernels.BATCHED_LAUNCHES)
    batch_ates, E_all, KF_all, R_all = [], 0, 0, 0
    for (B, sd), (system, wall_ms, finish_ms) in zip(batch_runs, batches):
        rmse, poses_c, revisit = tour_gates(f"batch {B} seed {sd}", system)
        batch_ates.append(rmse)
        K, K_serial = system.store.count, serial[sd].store.count
        K_rule = device_rule_keyframes(serial[sd])
        check(abs(K - K_rule) <= 0.2 * K_rule + 1,
              f"batch {B} seed {sd}: {K} keyframes, the scan's gate on the serial run's poses "
              f"{K_rule}")
        st = system.tracker.stats
        gap = float(np.linalg.norm(poses_c[:, :3, 3] - serial_poses[sd][:, :3, 3], axis=-1).max())
        log(f"[modes] batch {B} seed {sd}, {n_tour} frames: ATE {rmse:.5f} m, keyframes {K} "
            f"(the scan's gate on the serial run's poses {K_rule}, the serial gate {K_serial}), "
            f"loops closed {system.loops_closed}, graph "
            f"{system.graph.n_vertices} / {system.graph.n_edges} edges, failures {st.failures}, "
            f"relocalizations {st.relocalizations}, revisit {revisit}, largest position gap to "
            f"the serial run {gap:.5f} m")
        check(st.estimates == n_tour - 1, f"batch {B} seed {sd}: {st.estimates} estimates")
        E_all += st.estimates
        KF_all += K
        R_all += system.reloc_verifications
    check(float(np.median(batch_ates)) < 0.05,
          f"batch: median tour ATE {float(np.median(batch_ates))} m >= 0.05 m")
    p_db, p_seq = batches[0][0].camera_trajectory()[1], seq_system.camera_trajectory()[1]
    d_seq = float(np.abs(p_db - p_seq).max())
    log(f"[modes] batch 8 seed 0 completed batch by batch against double-buffered: poses max "
        f"abs diff {d_seq:.3g}, keyframes {seq_system.store.count} / "
        f"{batches[0][0].store.count}")
    check(d_seq <= 1e-4 and seq_system.store.count == batches[0][0].store.count,
          f"sequential and double-buffered batches differ by {d_seq}")
    E_all += seq_system.tracker.stats.estimates
    KF_all += seq_system.store.count
    R_all += seq_system.reloc_verifications
    n_runs = len(batch_runs) + 1
    expect_batch = dict(expect_tour, **{
        "detect_keypoints_fused": n_tour * n_runs,
        "hamming_match_2nn": E_all + 2 * KF_all + R_all,
        "match_gates": E_all + 2 * KF_all + R_all,
        "ransac_se3_fused": E_all + KF_all + R_all, "gicp_refine_fused": E_all})
    log(f"[modes] batch: ATE median {float(np.median(batch_ates)):.5f} m over "
        f"{len(batch_runs)} runs; launches {json.dumps(launches_batch)}; formula with "
        f"E={E_all} (frames - 1 per run, no retry), KF={KF_all}, R={R_all} -> "
        f"{json.dumps(expect_batch)}; batched {json.dumps(batched_batch)}")
    check(E_all == (n_tour - 1) * n_runs, f"batch: {E_all} estimates")
    check(launches_batch == expect_batch,
          f"batch launch counts {launches_batch} != {expect_batch}")
    check(batched_batch == {"hamming_match_2nn": KF_all + R_all, "match_gates": KF_all + R_all,
                            "mahal_hypothesis_scores": 0, "ransac_se3_fused": KF_all + R_all},
          f"batch batched launches {batched_batch}")

    # Host synchronisations by torch's sync debug mode, one more run of each
    # mode (seed 1, which closes a loop). Ring budget: the first frame is the
    # serial initialisation (keyframe 0's blob); then one read per frame (its
    # row, with the blob of the keyframe the previous completion
    # dispatched) once a frame is in the ring, one per retry, loop closure,
    # two per relocalization; the flush reads the last row and the last
    # keyframe's blob. Batch budget: none in a dispatch; a completion reads
    # its rows (with keyframe 0's blob in the first), the blobs of the
    # keyframes it dispatched, one per loop closure, two per relocalization.
    ring_syncs = {}

    def ring_counted(system, ts, gray, depth):
        tr = system.tracker
        init, had_row = tr.state is TrackerState.NOT_INITIALIZED, tr._pipe is not None
        before = counts(system)
        n, msg, _ = sync_calls(lambda: system.track_pipelined(ts, gray, depth))
        dE, dK, dL, dR = since(system, before)
        budget = dK if init else int(had_row) + (dE - 1) + dL + 2 * dR
        kind = ("first frame" if init else "no row yet" if not had_row else
                "relocalization" if dR else "loop closure" if dL else
                "retry" if dE > 1 else "frame")
        ring_syncs.setdefault(kind, []).append(n)
        check(n == budget, f"ring {kind} at t={ts:.3f}: {n} synchronisations, budget "
              f"{budget}; first: {msg!r}")

    with plain_versions_forbidden(kernels):
        ring_sys, _, _, _ = run_ring(1, per_frame=ring_counted, finish=False)
    log(f"[modes] ring synchronisations per call by kind: "
        f"{json.dumps({k: [min(v), max(v), len(v)] for k, v in ring_syncs.items()})} "
        f"([least, most, calls])")
    # the flush of a fresh ring run: its last row and the last keyframe's blob
    with plain_versions_forbidden(kernels):
        flush_sys, _, _ = run_tour(1, per_frame=feed_ring, finish=False, n=24)
    before = counts(flush_sys)
    n_flush, msg, _ = sync_calls(flush_sys.track_pipelined_flush)
    dE, dK, dL, dR = since(flush_sys, before)
    check(n_flush == 1 + dK + dE + dL + 2 * dR, f"ring flush: {n_flush} synchronisations "
          f"(keyframes {dK}); first: {msg!r}")
    batch_syncs = {"dispatch": [], "complete": []}
    with plain_versions_forbidden(kernels):
        run_batch(1, 8, counted=batch_syncs)
    log(f"[modes] ring flush: {n_flush} synchronisations; batch 8 seed 1: dispatches "
        f"{sorted(set(batch_syncs['dispatch']))} synchronisations each over "
        f"{len(batch_syncs['dispatch'])}, completions (count, budget) "
        f"{json.dumps(sorted(set(batch_syncs['complete'])))}")

    # batched ADAPTIVE on the card (tests/test_extractor_cli.py's scenario):
    # 9 frames from threshold 60, then 9 more. The run's first frame goes
    # through the host extractor, as in the JAX package: its re-detections
    # read the device once each, and these are the first dispatch's only
    # synchronisations. After it the threshold evolves on the device, read by
    # kernel A from there: the second dispatch never waits for the device.
    acfg = SlamConfig(extractor=ExtractorConfig(num_features=128, num_levels=2, cell_size=8,
                                                fast_threshold=60.0, adapt_target_min=60,
                                                adapt_target_max=120),
                      adaptive=True)
    orbit_small = SyntheticDataset(n_frames=48, cam=cam_small, trajectory="orbit", device=dev)
    a_frames = tuple(zip(*[orbit_small.grab(i) for i in range(9)]))
    a_frames2 = tuple(zip(*[orbit_small.grab(i) for i in range(9, 18)]))
    a_tr = Tracker(cam_small, acfg, seed=0, device=dev)
    with plain_versions_forbidden(kernels):
        n_adisp, msg, a_h = sync_calls(lambda: a_tr.track_batch_dispatch(*a_frames))
        a_reads = a_tr._extractor.reads
        a_tr.track_batch_complete(a_h)
        a_thr = a_tr._extractor.threshold
        n_adisp2, msg2, a_h = sync_calls(lambda: a_tr.track_batch_dispatch(*a_frames2))
        a_tr.track_batch_complete(a_h)
    log(f"[modes] batched ADAPTIVE, 9 frames 320x240 from threshold 60: threshold {a_thr:.4f} "
        f"(th_min {a_tr._extractor.th_min}), {n_adisp} synchronisations in the first dispatch "
        f"for {a_reads} detections of its first frame, {n_adisp2} in the second dispatch; "
        f"threshold after 18 frames {a_tr._extractor.threshold:.4f}")
    check(a_reads >= 2 and n_adisp == a_reads,
          f"the first ADAPTIVE batch dispatch synchronised {n_adisp} times for {a_reads} "
          f"detections: {msg!r}")
    check(n_adisp2 == 0, f"a later ADAPTIVE batch dispatch synchronised {n_adisp2} times: "
          f"{msg2!r}")
    check(a_thr < 60.0 * 0.7 + 1e-6 and a_thr >= a_tr._extractor.th_min - 1e-6,
          f"batched ADAPTIVE threshold {a_thr}")

    # times of the four modes in this call, host clock (every run ends in a
    # device read): the tracking step is the wall less the keyframe backend
    # (its dispatch and completion halves; in the ring and batched modes the
    # blob reads are shared with the rows and counted in the step)
    def mode_times(tag, system, wall_ms, finish_ms):
        kf_ms = np.array(system.kf_backend_ms)
        loop_ms = np.array(system.loop_solve_ms)
        log(f"[times] {tag}: {wall_ms / n_tour:.3f} ms/frame over {n_tour} frames; tracking "
            f"step {(wall_ms - kf_ms.sum()) / n_tour:.3f} ms/frame; keyframe backend "
            f"{kf_ms.mean():.3f} ms/keyframe x {len(kf_ms)} "
            f"({(kf_ms.sum() - loop_ms.sum()) / n_tour:.3f} ms/frame without the solves); "
            f"loop-closure solves {json.dumps([round(float(x), 1) for x in loop_ms])} ms; "
            f"final optimization {finish_ms:.1f} ms ({smi})")

    for sd, (system, ms, finish_ms) in zip(slam_seeds, tours):
        mode_times(f"serial seed {sd}", system, ms.sum(), finish_ms)
    for sd, (system, ms, flush_ms, finish_ms) in zip(slam_seeds, rings):
        mode_times(f"ring seed {sd}", system, ms.sum() + flush_ms, finish_ms)
    for (B, sd), (system, wall_ms, finish_ms) in zip(batch_runs, batches):
        mode_times(f"batch {B} seed {sd}", system, wall_ms, finish_ms)

    # ---------------------------------------------------------------- 8
    launches_disk, batched_disk = disk_phase(dev, smi, kernels)

    # ---------------------------------------------------------------- 5
    odo = odos[0]
    stages = ("features", "match", "ransac", "gicp", "step")

    def pipeline_ms():
        """ms per frame of odo.run over the sweep: host clock, and CUDA
        events on the stream around it."""
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        odo.run(frames)
        b.record()
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t0) / n_frames, a.elapsed_time(b) / n_frames

    def stage_loop(gicp_fn=gicp_refine):
        """The pipeline's per-frame work (features, match, RANSAC, GICP) in
        a loop with no sync, marked at each stage boundary by a CUDA event
        and by the host clock. Returns (host ms per frame of the loop,
        {stage: per-frame event ms}, {stage: per-frame host ms})."""
        marks = []
        f_prev = odo.features(frames[0][1], frames[0][2])
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i in range(1, n_frames):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            h = [0.0] * 5
            h[0] = time.perf_counter()
            e[0].record()
            fc = odo.features(frames[i][1], frames[i][2])
            h[1] = time.perf_counter()
            e[1].record()
            mm = match_frames(f_prev, fc, cfg.matcher.nn_ratio)
            q1, q2, ww, vv = gather_matched_points(f_prev, fc, mm)
            h[2] = time.perf_counter()
            e[2].record()
            rr = ransac_se3(q1, q2, ww, vv, odo.generator, cfg.ransac)
            h[3] = time.perf_counter()
            e[3].record()
            gicp_fn(q1, q2, rr.inliers, rr.T21, cfg.icp, C1=f_prev.surf_cov,
                    C2=fc.surf_cov[mm.idx2.long()])
            h[4] = time.perf_counter()
            e[4].record()
            marks.append((e, h))
            f_prev = fc
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t_start) / (n_frames - 1)
        spans = ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4))
        ev = {k: np.array([e[a].elapsed_time(e[b]) for e, _ in marks[2:]])
              for k, (a, b) in zip(stages, spans)}
        host = {k: np.array([1000 * (h[b] - h[a]) for _, h in marks[2:]])
                for k, (a, b) in zip(stages, spans)}
        return wall, ev, host

    def med(v):
        return round(float(np.median(v)), 3)

    times = []
    for rnd in range(3):
        p_host, p_ev = pipeline_ms()
        s_wall, s_ev, s_host = stage_loop()
        times.append(dict(pipeline_host=p_host, pipeline_event=p_ev, loop_host=s_wall,
                          event={k: med(v) for k, v in s_ev.items()},
                          host={k: med(v) for k, v in s_host.items()}))
        log(f"[times] round {rnd}: PipelinedOdometry.run {p_host:.3f} ms/frame host clock, "
            f"{p_ev:.3f} ms/frame CUDA events; stage loop {s_wall:.3f} ms/frame host clock "
            f"({smi})")
        log(f"[times] round {rnd}: stage loop medians over {len(s_ev['step'])} frames, "
            f"CUDA events {json.dumps(times[-1]['event'])}; host clock "
            f"{json.dumps(times[-1]['host'])} ({smi})")

    # device launches of one call, by the profiler: 2 per detect_keypoints
    # (kernels A and B), 1 per gicp_refine, at most 4 per ransac_se3 (the
    # uniform draws, kernel A, kernel B), at most 2 per match_descriptors (the
    # 2-NN, the gates), whatever the batch
    ecfg = cfg.extractor
    det_args = (ecfg.num_features, ecfg.cell_size, ecfg.fast_threshold, ecfg.min_response,
                ecfg.min_border)
    k4_call = dict(C1=k4_args[3], C2=k4_args[4])
    n_launch = {
        "detect_keypoints": device_launches(lambda: fast.detect_keypoints(pyr, *det_args)),
        "gicp_refine": device_launches(lambda: gicp_refine(
            k4_args[1], k4_args[2], k4_args[5], k4_args[0], icp, **k4_call)),
        "build_frame_features": device_launches(
            lambda: odo.features(frames[0][1], frames[0][2])),
        "ransac_se3": device_launches(
            lambda: ransac_se3(p1, p2, w, valid, odo.generator, cfg.ransac)),
        "ransac_se3 batch 13": device_launches(
            lambda: ransac_se3(Xb, p2b, wb, vb, odo.generator, cfg.ransac)),
        "match_descriptors": device_launches(
            lambda: match_descriptors(f0.desc, v1, f1.desc, v2, cfg.matcher.nn_ratio)),
        "match_descriptors batch 13": device_launches(
            lambda: match_descriptors(Db, Vb, f1.desc, v2, cfg.matcher.nn_ratio)),
    }
    log(f"[times] device launches per call, by the profiler: {json.dumps(n_launch)}")
    check(n_launch["detect_keypoints"] == 2, "detect_keypoints: not 2 device launches")
    check(n_launch["gicp_refine"] == 1, "gicp_refine: not 1 device launch")
    for k, v in n_launch.items():
        if k.startswith(("ransac_se3", "match_descriptors")):
            limit = 4 if k.startswith("ransac_se3") else 2
            check(0 < v <= limit, f"{k}: {v} launches, limit {limit}")

    # the host never waits for the device inside a step, and once per batch
    # in the pipeline (its device-to-host copy of the batch's results)
    f_a = odo.features(frames[0][1], frames[0][2])
    n_step, _, _ = sync_calls(
        lambda: odo.track_pair(f_a, odo.features(frames[1][1], frames[1][2])))
    n_run, msg, _ = sync_calls(lambda: odo.run(frames))
    n_batches = -(-(n_frames - 1) // odo.batch)
    log(f"[times] host-device synchronisations: {n_step} inside one step (features, "
        f"match, RANSAC, GICP); {n_run} in PipelinedOdometry.run over {n_frames} "
        f"frames in {n_batches} batches ({msg!r})")
    check(n_step == 0, f"one step synchronises {n_step} times")
    check(n_run == n_batches, f"the pipeline synchronised {n_run} times, expected one "
          f"per batch ({n_batches})")

    # device busy share and kernel time by name: 16 frame pairs of the
    # sweep's pipeline, and frames 32-47 of the tour through SlamSystem
    # (keyframe backend included)
    profile_busy(lambda: odo.run(frames[:17]), "16 frame pairs of the sweep", smi)
    prof_system, _, _ = run_tour(1, finish=False, n=32)
    profile_busy(lambda: [prof_system.track(*f) for f in tour_frames[32:48]],
                 f"16 tour frames of SlamSystem ({prof_system.store.count} keyframes "
                 f"before)", smi)
    # the same frames through the ring and through two batches of 8
    prof_ring, _, _ = run_tour(1, per_frame=feed_ring, finish=False, n=32)
    profile_busy(lambda: [prof_ring.track_pipelined(*f) for f in tour_frames[32:48]],
                 f"16 tour frames of the ring ({prof_ring.store.count} keyframes before)",
                 smi)
    prof_batch = SlamSystem(SYNTHETIC, slam_cfg, seed=1, device=dev)
    prof_batch.load_vocabulary(voc)
    for i in range(0, 32, 8):
        prof_batch.track_batch(*zip(*tour_frames[i:i + 8]))
    profile_busy(lambda: [prof_batch.track_batch(*zip(*tour_frames[i:i + 8]))
                          for i in (32, 40)],
                 f"16 tour frames in batches of 8 ({prof_batch.store.count} keyframes "
                 f"before)", smi)

    # device microseconds per launch of the whole detection, the whole
    # gicp_refine and the dense K1, by the profiler on isolated calls
    def k4_whole():
        gicp_refine(k4_args[1], k4_args[2], k4_args[5], k4_args[0], icp, **k4_call)

    dev_us = {}
    for fn in (lambda: fast.detect_keypoints(pyr, *det_args), k4_whole,
               lambda: [fast.masked_score_map(lvl, thr) for lvl in pyr]):
        dev_us.update(device_us_per_launch(fn))
    log(f"[times] device microseconds per launch, isolated calls: {json.dumps(dev_us)} "
        f"(detect_kernel: mean of the {len(pyr)} levels) ({smi})")

    def k1_kernel():
        for lvl in pyr:
            kernels.detect_score_map(lvl, thr)

    def k1_plain():
        for lvl in pyr:
            kernels.detect_score_map_ref(lvl, thr)

    timing = {
        "detect_score_map": paired_ms(k1_kernel, k1_plain),
        "hamming_match_2nn": paired_ms(
            lambda: kernels.hamming_match_2nn(f0.desc, f1.desc, v1, v2),
            lambda: kernels.hamming_match_2nn_ref(f0.desc, f1.desc, v1, v2)),
        "mahal_hypothesis_scores": paired_ms(
            lambda: kernels.mahal_hypothesis_scores(T_h, p1, p2, s1, s2, valid, th),
            lambda: kernels.mahal_hypothesis_scores_ref(T_h, p1, p2, s1, s2, valid, th)),
    }

    def k4_plain():
        fin = kernels.gicp_refine_ref(*k4_args, icp.max_iterations,
                                      icp.max_correspondence_dist)[0]
        _finish_gicp(fin, k4_args[0], k4_args[1], k4_args[2], k4_args[5], icp)

    # the whole calls as the main paths make them, against their plain versions
    timing["detect_keypoints_fused"] = paired_ms(
        lambda: fast.detect_keypoints(pyr, *det_args),
        lambda: fast.detect_keypoints_ref(pyr, *det_args))
    timing["gicp_refine_fused"] = paired_ms(k4_whole, k4_plain)
    timing["gicp_gn_normal_equations"] = paired_ms(
        lambda: kernels.gicp_gn_normal_equations(*k4_args, icp.max_correspondence_dist),
        lambda: kernels.gicp_gn_normal_equations_ref(*k4_args, icp.max_correspondence_dist))
    timing["hamming_match_2nn_b13"] = paired_ms(
        lambda: kernels.hamming_match_2nn(Db, f1.desc, Vb, v2),
        lambda: kernels.hamming_match_2nn_ref(Db, f1.desc, Vb, v2))
    timing["mahal_hypothesis_scores_b13"] = paired_ms(
        lambda: kernels.mahal_hypothesis_scores(T_hb, Xb, p2b, s1b, s2b, vb, th),
        lambda: kernels.mahal_hypothesis_scores_ref(T_hb, Xb, p2b, s1b, s2b, vb, th))
    # the whole calls as the main paths make them: the gated matcher, and
    # ransac_se3 with its uniform draws, against their tensor-code versions
    ratio = cfg.matcher.nn_ratio
    timing["match_gated"] = paired_ms(
        lambda: kernels.match_gated(f0.desc, f1.desc, v1, v2, ratio),
        lambda: kernels.match_gated_ref(f0.desc, f1.desc, v1, v2, ratio))
    timing["match_gated_b13"] = paired_ms(
        lambda: kernels.match_gated(Db, f1.desc, Vb, v2, ratio),
        lambda: kernels.match_gated_ref(Db, f1.desc, Vb, v2, ratio))
    timing["ransac_se3_fused"] = paired_ms(
        lambda: ransac_se3(p1, p2, w, valid, gen, rc),
        lambda: ransac_mod.ransac_se3_ref(p1, p2, w, valid, gen, rc))
    timing["ransac_se3_fused_b13"] = paired_ms(
        lambda: ransac_se3(Xb, p2b, wb, vb, gen, rc),
        lambda: ransac_mod.ransac_se3_ref(Xb, p2b, wb, vb, gen, rc))

    # Bounds from this run's shapes: every input byte read once, every
    # output byte written once; operations counted per element as the
    # kernel's source does them (see each .cu header).
    n_px = sum(int(lvl.numel()) for lvl in pyr)
    N, M = f0.desc.shape[0], f1.desc.shape[0]
    gicp_bytes = N * (3 + 3 + 9 + 9) * 4 + N + 64
    n_det_cells = (pyr[0].shape[0] // ecfg.cell_size) * (pyr[0].shape[1] // ecfg.cell_size)

    def k2_bound(b):       # 8 words x (xor, popcount, add) per descriptor pair
        return bound(b * N * 33 + M * 33 + b * (3 * N + M) * 4 + b * M * 8, b * N * M * 8 * 3)

    def k3_bound(b):       # ~100 float operations per (hypothesis, correspondence)
        return bound(b * (H * 64 + N * 49 + H * 8), b * H * N * 100)

    def gated_bound(b):    # K2's work, the gates' five operations and one flag per query
        return bound(b * N * 33 + M * 33 + b * N * 9, b * N * M * 8 * 3 + b * N * 5)

    def ransac_bound(b):
        """The function's work whatever implements it: H x N scorings of
        ~100 operations, H + refine_iters Horn fits (30 iterations of ~45
        operations and ~150 around them; a refit's moments ~40 per
        correspondence), refine_iters + 1 scorings of one pose (the winner's
        and each refit's: a second scoring of a refit repeats the first bit
        for bit and is not needed); p1, p2, w, valid and the uniforms read
        once, T21, the mask and three scalars written once."""
        r = rc.refine_iters
        fit = 30 * 45 + 150
        ops = H * N * 100 + (H + r) * fit + r * N * 40 + (r + 1) * N * 100
        return bound(b * (N * (24 + 4 + 1) + H * S * 4 + 64 + N + 9), b * ops)

    bounds = {
        # Sobel + 3 products + separable 9x9 boxes + eigenvalue + FAST arc + NMS: ~170/px
        "detect_score_map": bound(n_px * 4 * 3, n_px * 170),
        "hamming_match_2nn": k2_bound(1),
        "hamming_match_2nn_b13": k2_bound(13),
        "mahal_hypothesis_scores": k3_bound(1),
        "mahal_hypothesis_scores_b13": k3_bound(13),
        "match_gated": gated_bound(1),
        "match_gated_b13": gated_bound(13),
        "ransac_se3_fused": ransac_bound(1),
        "ransac_se3_fused_b13": ransac_bound(13),
        # the pyramid in, the keypoint slots out; the dense kernel's ~170/px, the
        # merge and the rank's comparisons (n_cells^2)
        "detect_keypoints_fused": bound(
            n_px * 4 + ecfg.num_features * 17,
            n_px * 170 + n_det_cells * (n_det_cells + 4 * len(pyr))),
        # ~300 float operations per correspondence and round, ~20 for the gate
        "gicp_refine_fused": bound(gicp_bytes + 64 + 5, N * (300 * icp.max_iterations + 20)),
        "gicp_gn_normal_equations": bound(gicp_bytes + 116, N * 300),
    }
    for k, (kms, pms) in timing.items():
        log(f"[times] {k}: kernel {kms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bounds[k][0]:.6f} ms by {bounds[k][1]}, library call none ({smi})")
    log("[times] every bound lies far under one launch's latency: K4, K5 and the fused "
        "RANSAC are held by their dependent block reductions (10, 1 and 2 + 4 x "
        f"{rc.refine_iters}) and serial solves and Horn fits, not by throughput")

    # launches per entry and main path (the sweep's pipeline, the tour
    # through the serial, ring and batched modes), each path driven with the
    # counts set to 0 just before it and read just after; an unbatched entry
    # counts its wrapper's unbatched launches, the _b13 entry its batched
    # ones. `off_path` holds the launches through a public entry that no main
    # path reaches, counted in phase 3: the dense K1 (fast.masked_score_map),
    # K3's scorer alone (mahal_hypothesis_scores) and K5
    # (icp.gicp_normal_equations). They are printed apart as
    # `launches_off_path`; an entry named here must show none on a main path,
    # every other entry must show some there.
    paths = {"sweep": (launches_sweep, {}), "tour": (launches_tour, batched_tour),
             "ring": (launches_ring, batched_ring), "batch": (launches_batch, batched_batch),
             "disk": (launches_disk, batched_disk)}

    def path_launches(wrapper, b13):
        out = {}
        for path, (counts, batched) in paths.items():
            n_batched = batched.get(wrapper, 0)      # K1, K4, K5 take no batch
            out[path] = n_batched if b13 else counts[wrapper] - n_batched
        return out

    check(detect_err["n"] == 10, f"the detection was held on {detect_err['n']} images")
    log(f"[kernels] the whole detection against the plain version on {detect_err['n']} "
        f"images: score max abs diff {detect_err['score']:.3g}, "
        f"{detect_err['unequal']} unequal uv, level or valid entries")
    results["detect_keypoints_fused"] = dict(max_abs_err=detect_err["score"])
    results["ransac_se3_fused"] = dict(max_abs_err=fused_err["ransac_se3_fused"])
    results["ransac_se3_fused_b13"] = dict(max_abs_err=fused_err["ransac_se3_fused_b13"])
    pallas = "rgbdslam_tpu/ops/pallas_kernels.py"
    # name: (source, TPU kernel, the wrapper whose count it reads)
    meta = {
        "detect_score_map": ("detect.cu", f"{pallas}:320", "detect_score_map"),
        "detect_keypoints_fused": ("detect.cu", f"{pallas}:320", "detect_keypoints_fused"),
        "hamming_match_2nn": ("hamming.cu", f"{pallas}:87", "hamming_match_2nn"),
        "hamming_match_2nn_b13": ("hamming.cu", f"{pallas}:87", "hamming_match_2nn"),
        "match_gated": ("hamming.cu", f"{pallas}:87", "match_gates"),
        "match_gated_b13": ("hamming.cu", f"{pallas}:87", "match_gates"),
        "mahal_hypothesis_scores": ("mahal.cu", f"{pallas}:480", "mahal_hypothesis_scores"),
        "mahal_hypothesis_scores_b13": ("mahal.cu", f"{pallas}:480",
                                        "mahal_hypothesis_scores"),
        "ransac_se3_fused": ("mahal.cu", f"{pallas}:480", "ransac_se3_fused"),
        "ransac_se3_fused_b13": ("mahal.cu", f"{pallas}:480", "ransac_se3_fused"),
        "gicp_refine_fused": ("gicp.cu", f"{pallas}:791", "gicp_refine_fused"),
        "gicp_gn_normal_equations": ("gicp.cu", f"{pallas}:829", "gicp_gn_normal_equations"),
    }
    line = {"kernels": []}
    for k, (src, replaces, wrapper) in meta.items():
        per_path = path_launches(wrapper, k.endswith("_b13"))
        line["kernels"].append(
            {"name": k, "route": "cuda", "source": f"rgbdslam_tpu_torch/csrc/{src}",
             "replaces": replaces,
             "launches": sum(per_path.values()) + off_path.get(k, 0),
             **{f"launches_{path}": n for path, n in per_path.items()},
             "launches_off_path": off_path.get(k, 0),
             "max_abs_err": results[k]["max_abs_err"],
             "ms": timing[k][0], "plain_ms": timing[k][1],
             "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None})
    for entry in line["kernels"]:
        on_path = sum(entry[f"launches_{path}"] for path in paths)
        if entry["name"] in off_path:
            check(on_path == 0 and entry["launches_off_path"] > 0,
                  f"{entry['name']}: {on_path} launches on a main path, "
                  f"{entry['launches_off_path']} through its public entry")
        else:
            check(on_path > 0, f"{entry['name']} was launched on no main path")
            check(entry["launches_disk"] > 0, f"{entry['name']} was not launched on the "
                  "disk path")
    log(json.dumps(line))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
