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
               its plain version.
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
    names = ["detect_score_map_ref", "hamming_match_2nn_ref",
             "mahal_hypothesis_scores_ref", "gicp_refine_ref"]
    saved = {n: getattr(kernels, n) for n in names}

    def forbid(name):
        def f(*a, **k):
            raise AssertionError(f"plain version {name} ran on the CUDA main path")
        return f

    try:
        for n in names:
            setattr(kernels, n, forbid(n))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def ds_cpu_frame(ds, i: int):
    """Frame i of `ds` rendered on the CPU: (gray, depth)."""
    from rgbdslam_tpu_torch.io.synthetic import render_frame

    return render_frame(ds.cam, ds.poses_twc[i], device="cpu")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from rgbdslam_tpu_torch.config import RansacConfig, SlamConfig
    from rgbdslam_tpu_torch.eval.ate import ate_rmse
    from rgbdslam_tpu_torch.frontend.matcher import gather_matched_points, match_frames
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
    from rgbdslam_tpu_torch.ops import _build, image, kernels
    from rgbdslam_tpu_torch.solvers.icp import gicp_refine
    from rgbdslam_tpu_torch.solvers.kabsch import weighted_rigid_transform
    from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag, ransac_se3
    from rgbdslam_tpu_torch.slam.pipeline import PipelinedOdometry

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

    # K1: four pyramid levels of a rendered frame and of integer images
    thr = cfg.extractor.fast_threshold
    pyr = image.build_pyramid(frames[0][1], cfg.extractor.num_levels)
    ints = [torch.randint(0, 256, p.shape, generator=gen, device=dev).to(torch.float32)
            for p in pyr]
    err, mism_render = 0.0, 0
    for kind, levels in (("rendered", pyr), ("integer", ints)):
        for lvl, img in enumerate(levels):
            km, kr = kernels.detect_score_map(img, thr)
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
            log(f"[kernels] K1 {kind} level {lvl} {tuple(img.shape)}: corners "
                f"{int(kk.sum())}, keep-mask mismatches {n_bad}")
    results["detect_score_map"] = dict(max_abs_err=err, keep_mismatch_rendered=mism_render)

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
    results["hamming_match_2nn"] = dict(max_abs_err=0.0)
    log(f"[kernels] K2 1024x1024: all four outputs equal; "
        f"{int((ko[1] < kernels.BIG).sum())} rows with a valid pair")

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

    # K4 on the first five frame pairs: their depth-patch covariances come
    # out slightly indefinite, where the Pallas kernel's Cholesky gave NaN
    icp = cfg.icp
    k4_err = 0.0
    fa = f0
    for i in range(1, 6):
        fb = f1 if i == 1 else odo.features(frames[i][1], frames[i][2])
        mk = match_frames(fa, fb, cfg.matcher.nn_ratio)
        q1, q2, qw, qv = gather_matched_points(fa, fb, mk)
        res = ransac_se3(q1, q2, qw, qv, gen, rc)
        C1, C2 = fa.surf_cov, fb.surf_cov[mk.idx2.long()].contiguous()
        inl, T0 = res.inliers.contiguous(), res.T21.contiguous()
        kT, kcost, kcnt = kernels.gicp_refine_kernel(T0, q1, q2, C1, C2, inl,
                                                     icp.max_iterations,
                                                     icp.max_correspondence_dist)
        pT, pcost, pcnt = kernels.gicp_refine_ref(T0, q1, q2, C1, C2, inl,
                                                  icp.max_iterations,
                                                  icp.max_correspondence_dist)
        check(bool(torch.isfinite(kT).all()), f"K4 non-finite on pair {i}")
        torch.testing.assert_close(kT, pT, rtol=1e-4, atol=1e-5)
        # the plain loop gates on |r| < d, the kernel on |r|^2 < d^2 (as the
        # Pallas kernel): a pair on the boundary may count in one only
        check(abs(float(kcnt) - float(pcnt)) <= 1.0, f"K4 count {kcnt} vs {pcnt}")
        torch.testing.assert_close(kcost, pcost, rtol=1e-3, atol=1e-6)
        k4_err = max(k4_err, float((kT - pT).abs().max()))
        log(f"[kernels] K4 pair {i} N=1024 x{icp.max_iterations}: T max abs diff "
            f"{float((kT - pT).abs().max()):.3g}, count {float(kcnt)} vs {float(pcnt)}, "
            f"{int(inl.sum())} inliers in")
        if i == 1:
            k4_args = (T0, q1, q2, C1, C2, inl)
        fa = fb
    results["gicp_refine_kernel"] = dict(max_abs_err=k4_err)

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
    launches = dict(kernels.LAUNCHES)
    ates = []
    for sd, (ts, poses, stats, wall) in zip(seeds, runs):
        rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
        ates.append(rmse)
        log(f"[slice] PipelinedOdometry batch 8, seed {sd}, {n_frames} frames: ATE "
            f"{rmse:.5f} m ({info['pairs']} pairs), failures {stats['failures']}, mean "
            f"inliers {stats['mean_inliers']}, wall {wall:.3f} s")
        check(poses.shape == (n_frames, 4, 4) and np.isfinite(poses).all(), "bad poses")
        check(stats["failures"] == 0, f"seed {sd}: {stats['failures']} failed frames")
    log(f"[slice] launches over the {len(seeds)} runs {json.dumps(launches)}")
    log(f"[slice] ATE over seeds {list(seeds)}: median {float(np.median(ates)):.5f} m, "
        f"max {max(ates):.5f} m")
    check(float(np.median(ates)) < 0.05,
          f"median ATE over seeds {seeds}: {float(np.median(ates))} m >= 0.05 m")
    pairs = n_frames - 1
    expect = {"detect_score_map": cfg.extractor.num_levels * n_frames * len(seeds),
              "hamming_match_2nn": pairs * len(seeds),
              "mahal_hypothesis_scores": pairs * len(seeds),
              "gicp_refine_kernel": pairs * len(seeds)}
    check(launches == expect, f"launch counts {launches} != {expect}")

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

    def stage_loop():
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
            gicp_refine(q1, q2, rr.inliers, rr.T21, cfg.icp, C1=f_prev.surf_cov,
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

    # the host never waits for the device inside a step, and once per batch
    # in the pipeline (its device-to-host copy of the batch's results)
    def sync_calls(fn):
        """Synchronising calls torch reports while fn() runs: (count, the
        first message)."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")   # warns once itself: not counted
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
        return len(msgs), (msgs[0][:80] if msgs else "")

    f_a = odo.features(frames[0][1], frames[0][2])
    n_step, _ = sync_calls(
        lambda: odo.track_pair(f_a, odo.features(frames[1][1], frames[1][2])))
    n_run, msg = sync_calls(lambda: odo.run(frames))
    n_batches = -(-(n_frames - 1) // odo.batch)
    log(f"[times] host-device synchronisations: {n_step} inside one step (features, "
        f"match, RANSAC, GICP); {n_run} in PipelinedOdometry.run over {n_frames} "
        f"frames in {n_batches} batches ({msg!r})")
    check(n_step == 0, f"one step synchronises {n_step} times")
    check(n_run == n_batches, f"the pipeline synchronised {n_run} times, expected one "
          f"per batch ({n_batches})")

    # device busy share and kernel time by name over 16 frame pairs
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        odo.run(frames[:17])
        window_ms = 1000 * (time.perf_counter() - t0)
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue                     # host-side op events repeat their kernels' time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    busy_ms = sum(r[0] for r in rows) / 1000
    if busy_ms > 0:
        log(f"[times] profiler, 16 frame pairs: wall {window_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f} %), "
            f"{sum(r[2] for r in rows)} kernel launches ({smi})")
        for dev_us, key, count in sorted(rows, reverse=True)[:10]:
            log(f"[times]   {dev_us / 1000:9.3f} ms  {count:6d}x  {key[:90]}")
    else:
        log("[times] profiler saw no device time")

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
        "gicp_refine_kernel": paired_ms(
            lambda: kernels.gicp_refine_kernel(*k4_args, icp.max_iterations,
                                               icp.max_correspondence_dist),
            lambda: kernels.gicp_refine_ref(*k4_args, icp.max_iterations,
                                            icp.max_correspondence_dist)),
    }
    for k, (kms, pms) in timing.items():
        log(f"[times] {k}: kernel {kms:.4f} ms, plain {pms:.4f} ms ({smi})")

    meta = {
        "detect_score_map": ("detect.cu", "rgbdslam_tpu/ops/pallas_kernels.py:319"),
        "hamming_match_2nn": ("hamming.cu", "rgbdslam_tpu/ops/pallas_kernels.py:86"),
        "mahal_hypothesis_scores": ("mahal.cu", "rgbdslam_tpu/ops/pallas_kernels.py:479"),
        "gicp_refine_kernel": ("gicp.cu", "rgbdslam_tpu/ops/pallas_kernels.py:790"),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": f"rgbdslam_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"],
         "ms": timing[k][0], "plain_ms": timing[k][1]}
        for k, (src, rep) in meta.items()]}
    log(json.dumps(line))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
