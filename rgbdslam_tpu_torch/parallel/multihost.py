"""Multi-process distribution of the SLAM backend (port of
rgbdslam_tpu/parallel/multihost.py).

The reference is a single-process system (SURVEY.md section 2.7: its only
"communication backend" is ~20 mutexes and one keyframe queue). Here each
process calls `initialize`, which joins a torch.distributed job over a TCP
store; the pose-graph edges (and BA landmarks) are sharded over the global
mesh, every process holding its own shards, and the Gauss-Newton reductions
ride `all_gather` collectives whose partials every process adds in rank
order (parallel/dist_ba.py: bit-identical sums on every process).

Backends: `gloo` on the CPU, and where processes share one card (gloo
stages the card's partials through the host); `nccl` where each process
has a card of its own. NCCL refuses two ranks on one GPU, so a job of more
processes than cards runs gloo: `initialize` raises on nccl there.

Per-shard state is O(K + E/n): replicated pose vectors, an edge shard and
the O(K) CG vectors, never a (6K)^2 matrix (see
dist_ba.distributed_pose_graph_optimize_cg).

Run as a module, this file is the per-process worker of the multi-process
test and of chip_smoke.py's phase 13:

  python -m rgbdslam_tpu_torch.parallel.multihost \\
      --coordinator localhost:9755 --num-processes 2 --process-id $i \\
      --devices-per-process 4 --vertices 64 --edges 256 --check
      # on the card(s) [--backend gloo|nccl]; --platform cpu: on the CPU
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_PLATFORM = "cuda"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               platform: str | None = None, devices_per_process: int | None = None,
               backend: str | None = None):
    """Join the torch.distributed job of one process of a multi-process
    run (`init_process_group` over a TCP store at `coordinator_address`,
    host:port). Returns torch.distributed.

    platform "cuda" (default; no card raises) or "cpu": the process's shards
    lie on card process_id % cards, or on the CPU. devices_per_process=N gives the process
    N shards of its device (the test and smoke configuration). backend:
    default gloo on the CPU and where processes share a card, nccl where
    each process has a card of its own; nccl on a shared card raises."""
    global _PLATFORM
    import torch
    import torch.distributed as dist

    from rgbdslam_tpu_torch import device as device_mod

    platform = platform or "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform {platform!r}: cpu or cuda")
    if platform == "cuda":
        device_mod.resolve_device("cuda")          # no card raises
        cards = torch.cuda.device_count()
        card = process_id % cards
        device_mod.set_process_card(card)
        torch.cuda.set_device(card)
        shared = num_processes > cards
        backend = backend or ("gloo" if shared else "nccl")
        if backend == "nccl" and shared:
            raise ValueError(f"nccl: {num_processes} processes on {cards} card(s); NCCL "
                             "refuses two ranks on one GPU, run gloo")
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError("the CPU runs gloo")
    if devices_per_process is not None:
        device_mod.set_virtual_devices(devices_per_process)
    _PLATFORM = platform
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist


def global_mesh(axis: str = "edges"):
    """1-D mesh over every shard of every process."""
    from rgbdslam_tpu_torch.parallel.dist_ba import make_mesh

    return make_mesh(axis=axis, device=_PLATFORM)


def make_global(x, mesh, spec):
    """The port's value for a host copy `x` of the whole value (every
    process holds the same full array: the SLAM state is replicated on the
    hosts). spec None or (): replicated, a tensor on the mesh's home
    device; spec an axis name: rows sharded (their count a multiple of the
    mesh size), this process's shards on their devices. Works the same in
    one process."""
    import torch

    from rgbdslam_tpu_torch.parallel.dist_ba import _split

    t = torch.from_numpy(np.ascontiguousarray(x))
    if spec is None or spec == ():
        return t.to(mesh.home)
    return tuple(_split(t, mesh))


def shard_edges_global(edges, mesh, axis: str = "edges"):
    """dist_ba.shard_edges from host arrays (the whole edge set on every
    process): pad E to a multiple of the global shard count (weight 0: no
    effect on the solve) and upload only this process's shards."""
    import torch

    from rgbdslam_tpu_torch.parallel.dist_ba import shard_edges
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges

    host = PoseGraphEdges(
        a=torch.from_numpy(np.asarray(edges.a, np.int64)),
        b=torch.from_numpy(np.asarray(edges.b, np.int64)),
        Z=torch.from_numpy(np.ascontiguousarray(edges.Z, np.float32)),
        weight=torch.from_numpy(np.ascontiguousarray(edges.weight, np.float32)))
    return shard_edges(host, mesh, axis)


def fetch_replicated(x) -> np.ndarray:
    """Host copy of a replicated result (each process reads its own copy,
    no cross-process transfer)."""
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Asynchronous loop-constraint exchange over TCP (SURVEY section 2.7 P7)
# ---------------------------------------------------------------------------


class ConstraintExchange:
    """Fire-and-forget exchange of loop-closure constraints between hosts.

    The solve itself rides synchronous collectives; loop constraints are
    discovered asynchronously by whichever host's tracker finds them and
    must reach the other hosts WITHOUT a barrier — the reference's analog is
    the PoseGraph thread consuming the tracker's queue across a thread
    boundary (Solver/PoseGraph.cpp:289-302); across machines the boundary is
    the network. Plain length-prefixed TCP with a listener thread per
    process: no collective, no rendezvous — publish() never blocks on the
    consumer, and poll() drains whatever has arrived before the next solve.

    Wire format per edge: fixed 80-byte payload
    [sender i32 | a i32 | b i32 | weight f32 | Z 16xf32] — the sender id
    keys receiver-side dedup (two hosts may legitimately discover
    constraints with identical content).
    """

    _EDGE_BYTES = 4 + 4 + 4 + 4 + 64

    def __init__(self, port: int, peers, sender: int = 0, host: str = "0.0.0.0"):
        import socket
        import threading

        self._sender = int(sender)
        self.peers = list(peers)           # "host:port" of every OTHER process
        self._rx = []
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]     # the one bound (port 0: any free)
        self._sock.listen(8)
        self._closing = False
        self._conns = {}
        self._thread = threading.Thread(target=self._listen, daemon=True)
        self._thread.start()

    # -- receive side ---------------------------------------------------
    def _listen(self):
        import threading

        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._drain, args=(conn,),
                             daemon=True).start()

    def _drain(self, conn):
        import numpy as _np

        buf = b""
        while not self._closing:
            try:
                chunk = conn.recv(4096)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= self._EDGE_BYTES:
                rec, buf = buf[: self._EDGE_BYTES], buf[self._EDGE_BYTES:]
                snd = int(_np.frombuffer(rec[0:4], _np.int32)[0])
                a = int(_np.frombuffer(rec[4:8], _np.int32)[0])
                b = int(_np.frombuffer(rec[8:12], _np.int32)[0])
                w = float(_np.frombuffer(rec[12:16], _np.float32)[0])
                Z = _np.frombuffer(rec[16:], _np.float32).reshape(4, 4).copy()
                with self._lock:
                    self._rx.append((snd, a, b, Z, w))

    # -- send side --------------------------------------------------------
    def _conn_to(self, peer: str):
        import socket

        if peer not in self._conns:
            host, port = peer.rsplit(":", 1)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(5.0)
            s.connect((host, int(port)))
            self._conns[peer] = s
        return self._conns[peer]

    def publish(self, a: int, b: int, Z: np.ndarray, weight: float = 1.0):
        """Ship one constraint to every peer; best-effort (a dead peer is
        skipped — elastic, like any network-side channel must be)."""
        rec = (np.int32(self._sender).tobytes()
               + np.int32(a).tobytes() + np.int32(b).tobytes()
               + np.float32(weight).tobytes()
               + np.asarray(Z, np.float32).tobytes())
        for peer in self.peers:
            try:
                self._conn_to(peer).sendall(rec)
            except OSError:
                self._conns.pop(peer, None)

    def poll(self):
        """Drain constraints received since the last poll (non-blocking)."""
        with self._lock:
            out, self._rx = self._rx, []
        return out

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass


def open_exchange(dist) -> ConstraintExchange:
    """This process's constraint channel in an initialised job whose
    processes share one host: a listener on a free port of localhost, the
    peers' ports learnt through the job's process group. The gather is a
    collective, so when it returns every process's listener is up and no
    publish can race a peer's bind."""
    pid, nproc = dist.get_rank(), dist.get_world_size()
    ex = ConstraintExchange(0, [], sender=pid, host="localhost")
    ports = [None] * nproc
    dist.all_gather_object(ports, ex.port)
    ex.peers = [f"localhost:{p}" for r, p in enumerate(ports) if r != pid]
    return ex


# ---------------------------------------------------------------------------
# Worker: deterministic distributed pose-graph solve + self-check / timing
# ---------------------------------------------------------------------------


def _make_problem(K: int, E: int, seed: int = 0):
    """Deterministic noisy pose-graph problem (identical on every process):
    a perturbed chain with random skip edges, measurements from the
    ground-truth poses, initial guess from the perturbed ones. Host arrays:
    (Twc0, PoseGraphEdges of numpy arrays, fixed, Twc_true)."""
    import torch

    from rgbdslam_tpu_torch.geometry import se3
    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges

    rng = np.random.default_rng(seed)
    xi_true = rng.normal(scale=0.2, size=(K, 6)).astype(np.float32)
    xi_true[0] = 0
    Twc_true = se3.exp(torch.from_numpy(xi_true)).numpy()
    a = np.concatenate(
        [np.arange(1, K), rng.integers(2, K, size=max(E - (K - 1), 0))]
    ).astype(np.int32)
    b = np.concatenate(
        [np.arange(0, K - 1),
         np.maximum(a[K - 1:] - rng.integers(2, 10, size=a.shape[0] - (K - 1)), 0)]
    ).astype(np.int32)
    Z = np.stack(
        [np.linalg.inv(Twc_true[i]) @ Twc_true[j] for i, j in zip(a, b)]
    ).astype(np.float32)
    xi0 = xi_true + rng.normal(scale=0.05, size=(K, 6)).astype(np.float32)
    xi0[0] = 0
    Twc0 = se3.exp(torch.from_numpy(xi0)).numpy()
    edges = PoseGraphEdges(
        a=a, b=b, Z=Z, weight=np.full(a.shape, 100.0, np.float32)
    )
    fixed = np.zeros((K,), bool)
    fixed[0] = True
    return Twc0, edges, fixed, Twc_true


def _exchange(args, dist, edges_np, E: int):
    """The asynchronous constraint exchange of `--exchange`: the
    last `num_processes` edges are "loop discoveries", one a process; each
    is published over TCP and every process merges them before solving.
    Returns (the full edge set in a deterministic order, constraints
    received)."""
    import time

    from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges

    nproc, pid = args.num_processes, args.process_id
    ex = open_exchange(dist)
    mine = E - nproc + pid
    received = {}
    acks = set()
    deadline = time.time() + 90.0
    last_pub = 0.0
    # single drive loop over the best-effort channel: keep re-publishing our
    # constraint (a peer whose listener wasn't up yet just dropped it;
    # duplicates dedup by sender); once we hold every peer's constraint,
    # publish an ack record (a = -1), and finish only when every peer has
    # acked too — pure TCP choreography, no collective
    while ((len(received) < nproc - 1 or len(acks) < nproc - 1)
           and time.time() < deadline):
        if time.time() - last_pub > 0.5:
            ex.publish(int(edges_np.a[mine]), int(edges_np.b[mine]),
                       edges_np.Z[mine], float(edges_np.weight[mine]))
            if len(received) == nproc - 1:
                ex.publish(-1, 0, np.eye(4, dtype=np.float32), 0.0)
            last_pub = time.time()
        for (snd, a, b, Z, w) in ex.poll():
            if a < 0:
                acks.add(snd)
            else:
                # dedup by the DISCOVERING PROCESS (two hosts may publish
                # identical-content constraints; each still counts)
                received[snd] = (a, b, Z, w)
        time.sleep(0.01)
    # final ack: the exit condition can be met between timer ticks, before
    # this process ever sent its own ack
    ex.publish(-1, 0, np.eye(4, dtype=np.float32), 0.0)
    for _ in range(100):   # drain any last in-flight acks
        if len(acks) >= nproc - 1:
            break
        for (snd, a, b, Z, w) in ex.poll():
            if a < 0:
                acks.add(snd)
        time.sleep(0.01)
    ex.close()
    exchanged = len(received)
    assert exchanged == nproc - 1, f"got {exchanged} constraints"
    assert len(acks) == nproc - 1, f"got {len(acks)} acks"
    # reassemble the full edge set deterministically: base edges + every
    # process's discovery in sender order — identical on all hosts
    disc = {(int(edges_np.a[E - nproc + p]), int(edges_np.b[E - nproc + p]))
            for p in range(nproc)}
    a_l = list(edges_np.a[: E - nproc])
    b_l = list(edges_np.b[: E - nproc])
    Z_l = list(edges_np.Z[: E - nproc])
    w_l = list(edges_np.weight[: E - nproc])
    received[pid] = (int(edges_np.a[mine]), int(edges_np.b[mine]),
                     edges_np.Z[mine].astype(np.float32), float(edges_np.weight[mine]))
    for snd in sorted(received):
        a, b, Z, w = received[snd]
        assert (a, b) in disc
        a_l.append(a)
        b_l.append(b)
        Z_l.append(Z)
        w_l.append(w)
    return PoseGraphEdges(a=np.asarray(a_l, np.int32), b=np.asarray(b_l, np.int32),
                          Z=np.stack(Z_l).astype(np.float32),
                          weight=np.asarray(w_l, np.float32)), exchanged


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:9755")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--platform", default="cuda", help="cuda (no card raises) or cpu")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: gloo on the CPU and on a shared card, "
                         "nccl with a card a process)")
    ap.add_argument("--vertices", type=int, default=64)
    ap.add_argument("--edges", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--cg-iters", type=int, default=64)
    ap.add_argument("--check", action="store_true",
                    help="compare against the local dense solve and the same solve on a "
                         "one-process mesh of as many shards")
    ap.add_argument("--exchange", action="store_true",
                    help="exercise the asynchronous loop-constraint exchange: each "
                         "process withholds one loop edge, publishes it over TCP, and "
                         "solves only after receiving the peers' constraints")
    args = ap.parse_args(argv)

    dist = initialize(args.coordinator, args.num_processes, args.process_id,
                      platform=args.platform, devices_per_process=args.devices_per_process,
                      backend=args.backend)
    import torch

    from rgbdslam_tpu_torch.parallel.dist_ba import (Mesh,
                                                     distributed_pose_graph_optimize_cg)

    assert dist.get_world_size() == args.num_processes
    mesh = global_mesh()
    K, E = args.vertices, args.edges
    Twc0, edges_np, fixed_np, Twc_true = _make_problem(K, E)
    exchanged = 0
    if args.exchange:
        edges_np, exchanged = _exchange(args, dist, edges_np, E)

    edges = shard_edges_global(edges_np, mesh)
    Twc = make_global(Twc0, mesh, None)
    fixed = make_global(fixed_np, mesh, None)

    Twc_opt, cost = distributed_pose_graph_optimize_cg(
        Twc, edges, fixed, mesh, args.iterations, args.cg_iters)
    out = fetch_replicated(Twc_opt)
    result = {
        "process_id": args.process_id,
        "processes": args.num_processes,
        "backend": dist.get_backend(),
        "device": str(mesh.home),
        "global_devices": mesh.size,
        "final_cost": float(fetch_replicated(cost)),
        "exchanged_constraints": exchanged,
        "reductions": mesh.reductions,
    }

    # recovery check against the ground truth (noise-free measurements, so
    # the optimum IS the ground truth up to the vertex-0 gauge)
    err_t = np.linalg.norm(out[:, :3, 3] - Twc_true[:, :3, 3], axis=-1)
    result["max_translation_err"] = float(err_t.max())

    if args.check:
        from rgbdslam_tpu_torch.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph

        home = mesh.home
        dense_edges = PoseGraphEdges(
            a=torch.from_numpy(edges_np.a).long().to(home),
            b=torch.from_numpy(edges_np.b).long().to(home),
            Z=torch.from_numpy(edges_np.Z).to(home),
            weight=torch.from_numpy(edges_np.weight).to(home))
        Twc_dense, _ = optimize_pose_graph(
            torch.from_numpy(Twc0).to(home), dense_edges, torch.from_numpy(fixed_np).to(home),
            args.iterations)
        diff = float(np.abs(out - Twc_dense.cpu().numpy()).max())
        # the same solve on a one-process mesh of as many shards: the sums
        # over the shards are added in the same order, so the bits agree
        one = Mesh([home] * mesh.size, mesh.axis)
        Twc_one, _ = distributed_pose_graph_optimize_cg(
            torch.from_numpy(Twc0).to(home), dense_edges, torch.from_numpy(fixed_np).to(home),
            one, args.iterations, args.cg_iters)
        result["max_diff_vs_dense"] = diff
        result["equal_one_process"] = bool(np.array_equal(out, Twc_one.cpu().numpy()))
        result["check_ok"] = bool(diff < 5e-3 and err_t.max() < 5e-3
                                  and result["equal_one_process"])

    # one JSON line per process; the launcher reads each
    print(json.dumps(result))
    sys.stdout.flush()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
