"""The metric arithmetic on made-up records: a rate over the window, the
95th percentile over every frame, the idle share from the union of busy
intervals, the idle gaps named by the host's call, and the detection and
matcher rooflines against the bounds the program's smoke script recorded
for the same shapes (PERF.md's kernel table: 0.000774, 0.000376 and
0.004884 ms)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from slambench import drive, peaks, trace
from slambench.manifest import load_module

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "tum_fast_brief.json").read_text())


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py")


def _session(i, t0, frames, step_s, finish_ms=0.0, kf_ms=(), loop_ms=(), profiled=False):
    s = drive.SessionRecord(index=i, pool_index=0, kf_backend_ms=list(kf_ms),
                            loop_solve_ms=list(loop_ms))
    s.t_start, s.setup_ms, s.profiled, s.finish_ms = t0, 10.0, profiled, finish_ms
    for f in range(frames):
        s.t_in[f] = t0 + f * step_s
        s.t_out[f] = t0 + (f + 2) * step_s
    s.t_end = t0 + (frames + 2) * step_s + finish_ms / 1e3
    return s


def test_rate_counts_every_returned_frame_over_the_window():
    sessions = [_session(0, 0.0, 100, 0.01, 200.0), _session(1, 1.3, 40, 0.01, 100.0)]
    run = drive.RunRecord(window_s=2.0, sessions=sessions, setup_s=5.0)
    assert metric("frames_per_s").read(run) == pytest.approx(140 / 2.0)
    assert metric("setup_s").read(run) == 5.0


def test_p95_is_over_all_frames():
    s = _session(0, 0.0, 100, 0.01)
    for f in range(95, 100):                      # five slow frames of 100
        s.t_out[f] = s.t_in[f] + 0.5
    run = drive.RunRecord(window_s=1.0, sessions=[s], setup_s=0.0)
    lat = sorted([20.0] * 95 + [500.0] * 5)
    assert metric("frame_ms_p95").read(run) == pytest.approx(np.percentile(lat, 95))
    assert metric("frame_ms_p95").read(drive.RunRecord(1.0, [], 0.0)) is None


def test_counter_metrics_leave_out_the_profiled_session():
    prof = _session(0, 0.0, 128, 0.05, 1000.0, [50.0] * 90, [900.0], profiled=True)
    s = _session(1, 10.0, 128, 0.01, 250.0, [8.0] * 90 + [508.0], [500.0])
    run = drive.RunRecord(window_s=20.0, sessions=[prof, s], setup_s=0.0)
    wall_ms = 1e3 * (s.t_end - s.t_start)
    expect = (wall_ms - 10.0 - sum(s.kf_backend_ms) - 250.0) / 128
    assert metric("tracking_step_ms").read(run) == pytest.approx(expect)
    assert metric("keyframe_backend_ms").read(run) == pytest.approx((90 * 8.0 + 8.0) / 91)
    assert metric("loop_solve_ms").read(run) == pytest.approx((500.0 + 250.0) / 2)


def test_idle_share_is_one_minus_the_union_of_busy_intervals():
    R = trace.Record
    dev = [R("k", 0, 100), R("k", 50, 150), R("k", 300, 400), R("Memcpy HtoD", 390, 500)]
    host = [R("cudaStreamSynchronize", 160, 290), R("cudaLaunchKernel", 140, 155)]
    s = trace.Summary(window_s=1000e-9, frames=2, host=host, device=dev, counters={})
    assert s.busy_s == pytest.approx(350e-9)
    run = drive.RunRecord(window_s=1.0, sessions=[], setup_s=0.0, trace=s)
    assert metric("device_idle_pct").read(run) == pytest.approx(65.0)
    assert metric("launches_per_frame").read(run) == pytest.approx(3 / 2)
    gaps = s.breakdown()["idle_gaps"]
    assert gaps == [["cudaStreamSynchronize", pytest.approx(150e-9)]]
    assert s.breakdown()["device_ops"][0] == ["k", pytest.approx(300e-9)]


def test_rooflines_match_the_recorded_bounds():
    ex = CONFIG["slam_config"]["extractor"]
    assert peaks.detect_bound_s(480, 640, ex["num_levels"], ex["cell_size"],
                                ex["num_features"]) * 1e3 == pytest.approx(0.000774, abs=5e-7)
    assert peaks.match_bound_s(1, 1024, 1024) * 1e3 == pytest.approx(0.000376, abs=5e-7)
    assert peaks.match_bound_s(13, 1024, 1024) * 1e3 == pytest.approx(0.004884, abs=5e-7)


def _kernel(name, start, us):
    return trace.Record(f"void (anonymous namespace)::{name}(int const*)", start,
                        start + int(us * 1000))


def test_roofline_readers():
    dev = [_kernel("detect_cells_kernel", 0, 21.0), _kernel("detect_select_kernel", 10**5, 4.0),
           _kernel("hamming_kernel", 2 * 10**5, 30.0), _kernel("match_gate_kernel", 3 * 10**5, 2.0),
           _kernel("hamming_kernel", 4 * 10**5, 60.0), _kernel("match_gate_kernel", 5 * 10**5, 4.0)]
    counters = {"k2": 2, "k2_batched": 1, "rows": [3]}
    s = trace.Summary(window_s=1.0, frames=1, host=[], device=dev, counters=counters)
    run = drive.RunRecord(window_s=1.0, sessions=[], setup_s=0.0, trace=s, config=CONFIG)
    ex = CONFIG["slam_config"]["extractor"]
    least = peaks.detect_bound_s(480, 640, ex["num_levels"], ex["cell_size"], ex["num_features"])
    assert metric("roofline_pct.detect").read(run) == pytest.approx(100 * least / 25e-6)
    least = peaks.match_bound_s(1, 1024, 1024) + peaks.match_bound_s(3, 1024, 1024)
    assert metric("roofline_pct.match").read(run) == pytest.approx(100 * least / 96e-6)
    s.counters = dict(counters, k2=3)            # the trace dropped a launch: no reading
    assert metric("roofline_pct.match").read(run) is None
    s.counters = dict(counters, rows=[3, 0])     # a verification the trace lacks
    assert metric("roofline_pct.match").read(run) is None
    run.trace = None
    assert metric("roofline_pct.detect").read(run) is None
