"""Run one cell of the benchmark once and print one JSON line.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run finds the cell in BENCHMARK.json and
its configuration, traffic mix, limits and metrics by name; loads (or, when
its sources changed, builds) the program's kernel library; makes its
sequences from the seed; runs one warm session on the cell's own entry and
shapes; then runs sessions back to back for `--seconds`. With `--trace 1`
the window's first session runs under torch.profiler and the line carries
the per-layer metrics, else the end-to-end ones. After the window the
program's outputs are judged against the plain reference (`check.py`).

A run without as many CUDA cards as the cell asks for, or with JAX or the
JAX package loaded when the window has closed, exits non-zero and prints no
result. `--control tf32` (or `bfloat16`) puts the reference, computed in
that precision, in the program's place for the feature comparison: such a
run must come out not correct.
"""

from __future__ import annotations

import os
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def slam_config(fields: dict):
    """The program's SlamConfig with the configuration file's fields set
    (a nested group replaces the named fields of its dataclass)."""
    from rgbdslam_tpu_torch.config import SlamConfig

    base, kw = SlamConfig(), {}
    for key, value in fields.items():
        cur = getattr(base, key)
        if dataclasses.is_dataclass(cur):
            kw[key] = dataclasses.replace(cur, **value)
        elif isinstance(cur, tuple):
            kw[key] = tuple(value)
        else:
            kw[key] = value
    return dataclasses.replace(base, **kw)


def camera(sensor: dict):
    from rgbdslam_tpu_torch.geometry.camera import Camera

    return Camera(sensor["fx"], sensor["fy"], sensor["cx"], sensor["cy"],
                  depth_factor=sensor["depth_factor"], width=sensor["width"],
                  height=sensor["height"], min_depth=sensor["min_depth"],
                  max_depth=sensor["max_depth"])


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        control: str = "", t_process: float = T_PROCESS, steps=None,
        controls: tuple = None) -> dict:
    """One run of `cell`; returns the result line's object (the `checks`
    key last). `device` "cpu" is for the benchmark's own tests; `steps`
    holds set-up steps already taken, in seconds. With `controls` (lower
    precisions, or none) the object also holds, under "readings", every number of
    the run and of each control on the same outputs (for `calibrate.py`)."""
    import numpy as np
    import torch

    from slambench import check, drive, generate
    from slambench import trace as trace_mod
    from slambench.generate import SESSION, WARM, derive_seed

    t = time.perf_counter()
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.slam.system import SlamSystem
    from rgbdslam_tpu_torch.ops import _build
    from slambench.observe import observed

    steps = dict(steps or {}, import_s=time.perf_counter() - t)
    t = time.perf_counter()
    if device == "cuda":
        _build.library()
    steps["library_s"] = time.perf_counter() - t

    cfg_file, traffic = cell.config, cell.traffic
    cfg = slam_config(cfg_file["slam_config"])
    cam = camera(cfg_file["sensor"])
    params = {"nn_ratio": cfg.matcher.nn_ratio, "track_gate_px": cfg.track_gate_px,
              "dense_levels": tuple(cfg.dense_icp_levels) if cfg.use_dense_icp else ()}
    system_class = observed(SlamSystem)
    t = time.perf_counter()
    pool = generate.make_pool(cfg_file, traffic, seed, device)
    steps["frames_s"] = time.perf_counter() - t
    t = time.perf_counter()
    voc = shipped_vocabulary(cfg.detector)
    if voc is None:
        raise FileNotFoundError(f"no shipped vocabulary for {cfg.detector}")
    with np.load(voc) as z:              # read once: every session loads it
        z["words"], z["idf"]
    steps["vocabulary_s"] = time.perf_counter() - t

    def maker(purpose: int):
        def make(k: int):
            system = system_class(cam, cfg, seed=derive_seed(seed, purpose, k),
                                  device=device)
            system.load_vocabulary(voc)
            return system
        return make

    t = time.perf_counter()
    drive.run_session(maker(WARM), pool[0], drive.SessionRecord(index=0, pool_index=0),
                      traffic, keep=False)
    if device == "cuda":
        torch.cuda.synchronize()
    steps["warm_session_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process
    log("[setup] " + " ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f" setup_s {setup_s:.3f}")

    from rgbdslam_tpu_torch.ops import kernels

    def counters():
        return {"k2": kernels.LAUNCHES["hamming_match_2nn"],
                "k2_batched": kernels.BATCHED_LAUNCHES["hamming_match_2nn"]}

    window_s, sessions, prof = drive.run_window(
        maker(SESSION), pool, traffic, seconds, trace_mod.profiler if trace else None,
        counters)
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    summary = None
    if trace:
        s0 = sessions[0]
        t = time.perf_counter()
        summary = trace_mod.summarize(prof, s0.t_end - s0.t_start, len(s0.t_out),
                                      dict(s0.counters, rows=s0.verify_rows))
        log(f"[trace] profiled session 0: {len(s0.t_out)} frames, "
            f"{len(summary.device)} device records, read in "
            f"{time.perf_counter() - t:.3f} s")
    record = drive.RunRecord(window_s=window_s, sessions=sessions, setup_s=setup_s,
                             trace=summary, config=cfg_file)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = cell.reader(m).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = [x for s in sessions for x in s.latencies_ms]
    log(f"[window] {window_s:.3f} s, {len(sessions)} sessions, "
        f"{record.frames_returned} frames, latency samples {len(lat)}")
    log("[sessions] (wall ms, frames, keyframes, keyframe backend ms, loop solves ms, "
        "finish ms): "
        + ", ".join(f"({1e3 * (s.t_end - s.t_start):.0f}, {len(s.t_out)}, {s.keyframes}, "
                    f"{sum(s.kf_backend_ms):.0f}, "
                    f"{'+'.join(f'{x:.0f}' for x in s.loop_solve_ms)}, "
                    f"{s.finish_ms:.0f})" for s in sessions))

    outputs = check.program_outputs(sessions, seed, cfg_file["sensor"]["fps"])
    attempted = sum(len(s.t_in) for s in sessions)
    for s in sessions:
        s.system = None
    prof = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values, seen = check.numbers(pool, outputs, cfg_file, params, device, control)
    correct, checks = check.judge(values, cell.limits)
    readings = {"program": values, "seen": seen}
    for c in controls or ():
        readings[c] = check.numbers(pool, outputs, cfg_file, params, device, c)[0]
    log(f"[check] reference and comparison {time.perf_counter() - t:.3f} s; sessions "
        "(loops closed, ATE m): "
        + ", ".join(f"({s.loops_closed}, {a:.5f})" for s, a in zip(sessions, seen["ates"])))
    log("[numbers] " + " ".join(f"{k} {v}" for k, v in values.items())
        + " " + " ".join(f"{k} {v}" for k, v in seen.items() if k != "ates"))

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": correct, "attempted": attempted, "failed": outputs["missing"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    if controls is not None:
        result["readings"] = readings
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "bfloat16"), default="")
    args = p.parse_args(argv)
    # one host thread for the math libraries, set before numpy and torch
    # load them: the program's host path is one Python thread, and pool
    # threads spinning beside it on a shared host widen the runs' spread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    from slambench import guard
    from slambench.manifest import Cell

    bad = guard.reference_imports_forbidden(ROOT / "slambench" / "reference")
    if bad:
        log(f"the reference imports what it may not: {bad}")
        return 4
    cell = Cell(ROOT, args.workload)
    t = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    torch.cuda.init()
    steps = {"torch_s": time.perf_counter() - t}
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control,
                 steps=steps)
    found = guard.loaded_forbidden()
    if found:
        log(f"loaded after the window, and not allowed: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
