"""Live multi-PROCESS SLAM: a tracking process + backend peer processes
(port of rgbdslam_tpu/parallel/mp_slam.py).

The reference's backend is a live concurrent consumer of the tracker's
keyframes across a THREAD boundary (Solver/PoseGraph.cpp:59-103, 289-302:
the PoseGraph thread polls a mutex-guarded queue every 3 ms). Here the
boundary is an OS process:

  * process 0 runs the full SlamSystem (tracking, keyframes, loop
    detection) and PUBLISHES every pose-graph mutation — vertices,
    odometry / proximity / loop edges, solve announcements — over the
    asynchronous TCP constraint channel (multihost.ConstraintExchange;
    publish() never blocks on the consumer, like the reference's queue
    insert);
  * backend peer processes hold an identical PoseGraph mirror built from
    the received records and JOIN every solve: each solve is the
    edge-sharded CG LM (parallel/dist_ba.py) over the global mesh of every
    process's shards, its reductions all-gathered across the processes.

Determinism contract: the mirrors must hold identical vertex and edge
arrays when a solve starts (each process computes its own shards of the
same value). This holds because (a) the channel is one TCP connection per
peer, so records apply in publish order, (b) a solve is announced after
every mutation it depends on, and (c) between solves the only writer of
graph state is process 0; the solves' results are bit-identical on every
process, because every process adds the same gathered partials in rank
order (Mesh.psum). Local and global BA must be OFF in this mode: they move
poses outside the mirrored channel (asserted below).

Record encoding over the fixed 80-byte ConstraintExchange wire format
[sender i32 | a i32 | b i32 | weight f32 | Z 16xf32]:

  EDGE    a,b >= 0   Z = measurement T_{a<-b}; the provenance kind
                     (1 odometry / 2 proximity / 3 loop) rides Z[3,0] —
                     an SE(3) matrix's bottom row is [0,0,0,1], so the
                     lane is free and the wire format stays unchanged
  VERTEX  a = -2     b = vertex id, Z = Twc at creation
  SOLVE   a = -3     b = iterations, weight = n_edges, Z[0,0] = n_vertices
  DONE    a = -4     run over; peers drain and exit

Run as a module, this file is the per-process worker of
tests/test_torch_mp_slam.py and of chip_smoke.py's phase 13:

  python -m rgbdslam_tpu_torch.parallel.mp_slam \\
      --coordinator localhost:9755 --num-processes 2 --process-id $i \\
      --devices-per-process 4 --scene tour --frames 128
      # the 640x480 tour on the card; --platform cpu --scene orbit --frames
      # 80: the 320x240 orbit on the CPU (the test's run)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from rgbdslam_tpu_torch.parallel.multihost import (ConstraintExchange, global_mesh,
                                                   initialize, open_exchange)

_VERTEX, _SOLVE, _DONE = -2, -3, -4


def attach_publisher(graph, ex: ConstraintExchange) -> None:
    """Wire a PoseGraph's mutation hooks to the constraint channel
    (process 0 side)."""

    def on_vertex(k: int, Twc: np.ndarray):
        ex.publish(_VERTEX, k, Twc, 0.0)

    def on_edge(a: int, b: int, Z: np.ndarray, w: float, kind: int):
        Zk = np.asarray(Z, np.float32).copy()
        Zk[3, 0] = float(kind)
        ex.publish(a, b, Zk, w)

    def on_solve(iterations: int, n_vertices: int, n_edges: int):
        Zs = np.zeros((4, 4), np.float32)
        Zs[0, 0] = float(n_vertices)
        ex.publish(_SOLVE, iterations, Zs, float(n_edges))

    graph.on_vertex = on_vertex
    graph.on_edge = on_edge
    graph.on_solve = on_solve


def run_backend_peer(graph, ex: ConstraintExchange,
                     poll_s: float = 0.002, timeout_s: float = 600.0) -> dict:
    """Backend peer drive loop: apply records in order, join every solve.

    The reference analog is PoseGraph::run's 3 ms poll of the keyframe queue
    (Solver/PoseGraph.cpp:99); here the queue is the TCP channel and the
    'consume' step of a solve announcement is joining the collectives."""
    stats = {"vertices": 0, "edges_odometry": 0, "edges_proximity": 0,
             "edges_loop": 0, "solves_joined": 0}
    kind_key = {1: "edges_odometry", 2: "edges_proximity", 3: "edges_loop"}
    deadline = time.time() + timeout_s
    done = False
    while not done:
        recs = ex.poll()
        if not recs:
            if time.time() > deadline:
                raise TimeoutError("backend peer: no DONE before timeout")
            time.sleep(poll_s)
            continue
        for (_snd, a, b, Z, w) in recs:
            if a == _VERTEX:
                k = graph.add_vertex(Z)
                assert k == b, f"vertex mirror skew: got {k}, expected {b}"
                stats["vertices"] += 1
            elif a == _SOLVE:
                n_v, n_e = int(round(Z[0, 0])), int(round(w))
                assert graph.n_vertices == n_v and graph.n_edges == n_e, (
                    f"mirror skew at solve: have ({graph.n_vertices} v, "
                    f"{graph.n_edges} e), announced ({n_v}, {n_e})")
                graph.optimize(int(b))
                stats["solves_joined"] += 1
            elif a == _DONE:
                done = True
            else:
                kind = int(round(Z[3, 0]))
                Zc = np.asarray(Z, np.float32).copy()
                Zc[3, 0] = 0.0
                graph.add_edge(int(a), int(b), Zc, weight=float(w), kind=kind)
                stats[kind_key.get(kind, "edges_proximity")] += 1
    return stats


def _make_config(scene: str = "orbit"):
    """The run configuration — IDENTICAL on every process (the peer builds
    its PoseGraph mirror from it). "orbit": tests/test_distributed_system.py's
    operating point (320x240), so that the 2-process trajectory compares
    directly with the one-process runs; "tour": the 640x480 configuration of
    chip_smoke.py's tour."""
    from rgbdslam_tpu_torch.config import ExtractorConfig, LoopConfig, SlamConfig

    if scene == "tour":
        return SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10),
                          distributed=True)
    return SlamConfig(
        extractor=ExtractorConfig(num_features=1024, num_levels=3,
                                  cell_size=8, fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10,
                        vocab_size=256),
        distributed=True,
    )


def _make_scene(scene: str, n: int, device):
    """(camera, dataset) of a scene: the 320x240 orbit, or the 640x480
    multi-room tour with its revisit (tour_trajectory(n, loops=1.15))."""
    from rgbdslam_tpu_torch.geometry.camera import SYNTHETIC, Camera
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    if scene == "tour":
        return SYNTHETIC, SyntheticDataset(n_frames=n, cam=SYNTHETIC, trajectory="tour",
                                           loops=1.15, device=device)
    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    return cam, SyntheticDataset(n_frames=n, cam=cam, trajectory="orbit", loops=1.15,
                                 device=device)


def run_tracking(cfg, scene: str, n: int, device, seed: int = 0, graph_hook=None):
    """Process 0's run (and the one-process runs it is compared with): the
    full SlamSystem over the scene's n frames, the tour with the shipped
    vocabulary. `graph_hook(graph)` runs before the first frame. Returns
    (system, dataset, wall seconds of the frames and finish())."""
    from rgbdslam_tpu_torch.loop.vocabulary import shipped_vocabulary
    from rgbdslam_tpu_torch.slam.system import SlamSystem

    cam, ds = _make_scene(scene, n, device)
    system = SlamSystem(cam, cfg, seed=seed, device=device)
    if scene == "tour":
        system.load_vocabulary(shipped_vocabulary(cfg.detector))
    if graph_hook is not None:
        graph_hook(system.graph)
    t0 = time.perf_counter()
    for i in range(n):
        system.track(*ds.grab(i))
    system.finish()
    return system, ds, time.perf_counter() - t0


def _make_graph_mirror(cfg, mesh):
    """Peer-side PoseGraph with construction parameters identical to
    SlamSystem.__init__'s (slam/system.py), on the mesh's home device."""
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraph

    g = PoseGraph(
        cfg.keyframe.max_keyframes,
        cfg.pose_graph.max_edges,
        information=cfg.pose_graph.edge_information,
        huber_delta=cfg.pose_graph.huber_delta,
        cg_threshold=cfg.pose_graph.cg_vertex_threshold,
        cg_iters=cfg.pose_graph.cg_iters,
        lm_lambda0=cfg.pose_graph.lm_lambda0,
        device=mesh.home,
    )
    g.mesh = mesh
    return g


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:9755")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--platform", default="cuda", help="cuda (no card raises) or cpu")
    ap.add_argument("--backend", default=None, help="gloo or nccl (multihost.initialize)")
    ap.add_argument("--scene", default="orbit", choices=("orbit", "tour"))
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--out", default=None,
                    help="process 0: write the camera trajectory npz here")
    args = ap.parse_args(argv)
    pid, nproc = args.process_id, args.num_processes

    dist = initialize(args.coordinator, nproc, pid, platform=args.platform,
                      devices_per_process=args.devices_per_process, backend=args.backend)
    assert dist.get_world_size() == nproc
    # the constraint channel: every listener is up when this returns, so no
    # publish can race a peer's bind
    ex = open_exchange(dist)
    mesh = global_mesh()
    device = mesh.home

    cfg = _make_config(args.scene)
    result = {"process_id": pid, "processes": nproc, "backend": dist.get_backend(),
              "device": str(device), "global_devices": mesh.size}

    if pid == 0:
        from rgbdslam_tpu_torch.eval.ate import ate_rmse

        # local / global BA move keyframe poses outside the mirrored
        # channel: the multi-process contract forbids them (docstring)
        assert not cfg.use_local_ba and not cfg.use_global_ba, (
            "multi-process SLAM requires the pose-graph-only backend")

        n = args.frames

        def hook(graph):
            # the distributed flag already put every solve on the global
            # mesh (the default group spans every process)
            assert graph.mesh is not None and graph.mesh.size == mesh.size
            attach_publisher(graph, ex)

        system, ds, wall = run_tracking(cfg, args.scene, n, device, graph_hook=hook)
        # a warm solve, the peers joining it like any other announced solve
        t0 = time.perf_counter()
        system.graph.optimize(cfg.pose_graph.opt_iters_default)
        warm_s = time.perf_counter() - t0
        ex.publish(_DONE, 0, np.eye(4, dtype=np.float32), 0.0)

        ts_c, poses_c = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps[:n], ds.poses_twc[:n])
        result.update(
            frames=n,
            fps=round(n / wall, 2),
            keyframes=system.store.count,
            loops_closed=system.loops_closed,
            graph_edges=system.graph.n_edges,
            dist_solves=system.graph.dist_solves,
            loop_solve_ms=system.loop_solve_ms,
            warm_solve_ms=round(warm_s * 1e3, 1),
            ate_rmse=round(float(rmse), 5),
        )
        if args.out:
            np.savez(args.out, timestamps=ts_c, poses_twc=poses_c)
    else:
        graph = _make_graph_mirror(cfg, mesh)
        stats = run_backend_peer(graph, ex)
        result.update(stats)
        result["dist_solves"] = graph.dist_solves

    ex.close()
    print(json.dumps(result))
    sys.stdout.flush()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
