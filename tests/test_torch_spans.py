"""The span recorder (rgbdslam_tpu_torch/utils/profiling.py) on tiny ring
and batched sessions: off it reads no clock and records nothing; on it
changes no result; the counters of `SlamSystem` are its spans' durations;
reads nest in their parents; and spans fall on torch.profiler's clock.

This module imports torch and the port only, so that its `gpu` test runs
on the card's machine (`python -m pytest --noconftest -m gpu
tests/test_torch_spans.py`).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from rgbdslam_tpu_torch.config import (ExtractorConfig, LoopConfig, PoseGraphConfig,
                                       RansacConfig, SlamConfig)
from rgbdslam_tpu_torch.geometry.camera import Camera
from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset
from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
from rgbdslam_tpu_torch.slam.system import SlamSystem
from rgbdslam_tpu_torch.utils import profiling
from rgbdslam_tpu_torch.utils.profiling import SPANS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
# small enough for seconds on the CPU: the batches run the 16-frame orbit,
# which closes one BoW loop, the ring its first half; both fail a few frames
# (the ring's second-reference retries)
CFG = SlamConfig(extractor=ExtractorConfig(num_features=128, num_levels=2, cell_size=8,
                                           fast_threshold=15.0),
                 ransac=RansacConfig(num_hypotheses=32), use_icp_refinement=False,
                 pose_graph=PoseGraphConfig(max_proximity_candidates=3, opt_iters_loop=3,
                                            opt_iters_default=2),
                 loop=LoopConfig(id_interval=2, min_kfs_since_loop=2, max_candidates=2))
N, B = 16, 4
FRAMES = {"ring": N // 2, "batched": N}
#: the clock error the spans are held to against the profiler's records
CLOCK_ERROR_NS = 50_000
#: the pause before each clock probe: over twice CLOCK_ERROR_NS
GAP_S = 1e-3


def session(frames, mode: str, device: str) -> SlamSystem:
    system = SlamSystem(CAM, CFG, seed=0, device=device)
    system.load_vocabulary(shipped_vocabulary("svo_fast"))
    if mode == "ring":
        for f in frames:
            system.track_pipelined(*f)
        system.track_pipelined_flush()
    else:
        pending = None
        for i in range(0, len(frames), B):
            h = system.track_batch_dispatch(*zip(*frames[i:i + B]))
            if pending is not None:
                system.track_batch_complete(pending)
            pending = h
        system.track_batch_complete(pending)
    system.finish()
    return system


def _frames(device: str) -> list:
    ds = SyntheticDataset(N, CAM, trajectory="orbit", device=device)
    return [ds.grab(i) for i in range(N)]


def _raise(*_):
    raise AssertionError("a span read the clock while the recorder was off")


@pytest.fixture(scope="module")
def runs():
    """Each mode once with the recorder off (its clock made to raise) and
    once on."""
    frames = _frames("cpu")
    out = {}
    for mode in ("ring", "batched"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "clock", _raise)
            out[mode, False] = session(frames[:FRAMES[mode]], mode, "cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SPANS, "forced", True)
            out[mode, True] = session(frames[:FRAMES[mode]], mode, "cpu")
    return out


@pytest.mark.parametrize("mode", ["ring", "batched"])
def test_off_records_nothing_and_on_changes_nothing(runs, mode):
    off, on = runs[mode, False], runs[mode, True]
    assert off.spans == [] and len(on.spans) > 4 * FRAMES[mode]
    for a, b in ((off.camera_trajectory(), on.camera_trajectory()),
                 (off.keyframe_trajectory(), on.keyframe_trajectory())):
        np.testing.assert_array_equal(a[1], b[1])
    assert off.store.count == on.store.count and off.loops_closed == on.loops_closed
    assert len(off.kf_backend_ms) == off.store.count and len(off.loop_solve_ms) >= (
        mode == "batched")


@pytest.mark.parametrize("mode", ["ring", "batched"])
def test_counters_are_span_durations(runs, mode):
    system = runs[mode, True]
    spans = system.spans
    for k, ms in enumerate(system.kf_backend_ms):
        want = 0.0
        for s in spans:
            if s.index == k and s.name in ("backend.dispatch", "backend.read",
                                           "backend.complete"):
                want += (s.end_ns - s.start_ns) / 1e6
        assert ms == want, k
    finish = {s.id for s in spans if s.name == "loop.finish"}
    solves = [round((s.end_ns - s.start_ns) / 1e6, 2) for s in spans
              if s.name == "loop.optimize" and s.parent not in finish]
    assert solves == system.loop_solve_ms and len(finish) == 1


@pytest.mark.parametrize("mode", ["ring", "batched"])
def test_reads_lie_inside_their_parents(runs, mode):
    spans = runs[mode, True].spans
    by_id = {s.id: s for s in spans}
    reads = [s for s in spans if s.name in ("tracker.read", "backend.read")]
    assert len(reads) >= FRAMES[mode] // (B if mode == "batched" else 1)
    for s in reads:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.thread == s.thread
        assert p.name.split(".")[0] in ("tracker", "backend", "session"), p.name
    names = {s.name for s in spans}
    assert {"session.init", "session.vocabulary", "loop.finish", "lm.linearize",
            "tracker.complete", "backend.dispatch", "backend.complete"} <= names
    assert ("tracker.ring" if mode == "ring" else "tracker.dispatch") in names


def held(spans: list, records: list) -> None:
    """The i-th span holds the i-th outermost record (start, end) within
    CLOCK_ERROR_NS at each edge, the first pair excluded (its clock
    conversion is still settling). The probes run GAP_S apart, over twice
    the error, so no span can hold another's record. (A CPU op's record may
    hold a nested record of the same name.)"""
    outer = []
    for a, b in sorted(records, key=lambda r: (r[0], -r[1])):
        if not outer or b > outer[-1][1]:
            outer.append((a, b))
    records = outer
    assert len(records) == len(spans)
    for sp, (a, b) in list(zip(spans, records))[1:]:
        assert a - sp.start >= -CLOCK_ERROR_NS and sp.end - b >= -CLOCK_ERROR_NS, (
            a - sp.start, sp.end - b)


def test_spans_share_the_profilers_clock():
    """A span around an op holds the CPU profiler's record of that op
    (within CLOCK_ERROR_NS); the profiler alone turns the recorder on."""
    x = torch.ones(1000)
    spans = []
    assert not SPANS.on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(12):
            time.sleep(GAP_S)
            with SPANS.span("probe") as sp:
                x.sum()
            spans.append(sp)
    assert not SPANS.on()
    held(spans, sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                       if e.name() == "aten::sum"))


def test_a_span_belongs_to_the_session_it_opened_in():
    """A span still open when a new session starts goes to the session it
    opened in; the recorder keeps only the newest session's list."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SPANS, "forced", True)
        first = SPANS.new_session()
        with SPANS.span("old"):
            second = SPANS.new_session()
            with SPANS.span("new"):
                pass
    assert [s.name for s in first] == ["old"] and [s.name for s in second] == ["new"]
    assert SPANS.records is second


@pytest.mark.gpu
def test_runtime_calls_fall_inside_spans_on_the_card():
    """On the card, a profiled session's CUDA runtime calls start inside
    the system's spans (>= 99 %), and a span around a synchronisation holds
    the trace's cudaDeviceSynchronize within CLOCK_ERROR_NS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rgbdslam_tpu_torch.ops import _build

    _build.library()
    frames = _frames("cuda")
    session(frames, "batched", "cuda")                     # warm
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        system = session(frames, "batched", "cuda")
        syncs = []
        for _ in range(5):
            time.sleep(GAP_S)
            with SPANS.span("probe") as sp:
                torch.cuda.synchronize()
            syncs.append(sp)
        time.sleep(GAP_S)
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    spans = [s for s in system.spans if s.thread == system.spans[0].thread]
    lo, hi = min(s.start_ns for s in spans), max(s.end_ns for s in spans)
    calls = [t for n, t, _ in host if n.startswith("cuda") and lo <= t < hi]
    inside = sum(1 for t in calls if any(s.start_ns <= t < s.end_ns for s in spans))
    assert len(calls) > 100 and inside >= 0.99 * len(calls), (inside, len(calls))
    lo, hi = syncs[0].start - CLOCK_ERROR_NS, syncs[-1].end + CLOCK_ERROR_NS
    held(syncs, sorted((a, b) for n, a, b in host
                       if n == "cudaDeviceSynchronize" and lo <= a and b <= hi))
