"""The system under test, with what the check and the match roofline read
copied out as the timed path produces it. Each hook calls the program's own
method and only copies host values it already holds; nothing of the
program's work changes.

- `bench_track[k]`: keyframe k's track extension against keyframe k - 1,
  the (N,) packed lane of its backend blob (nearest index + 4096 x kept),
  and `bench_t21[k]`, the relative pose the device gated it with;
- `bench_rows[k]`: the verification rows whose results keyframe k uses
  (its proximity candidates, and its valid loop candidates when the loop
  gate is open), and `bench_reloc_rows`, a relocalization's candidates;
- `bench_solves`: each pose-graph solve's input graph and output poses.
"""

from __future__ import annotations

import numpy as np


def observed(base):
    """A subclass of the program's `SlamSystem` class `base` with the hooks."""
    from rgbdslam_tpu_torch.geometry import se3

    class Observed(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.bench_track, self.bench_t21, self.bench_rows = {}, {}, {}
            self.bench_reloc_rows, self.bench_solves = [], []
            graph, solve = self.graph, self.graph.optimize

            def optimize(iterations: int = 10):
                K, E = graph.n_vertices, graph.n_edges
                snap = {"Twc": graph.Twc[:K].copy(), "a": graph.e_a[:E].copy(),
                        "b": graph.e_b[:E].copy(), "Z": graph.e_Z[:E].copy(),
                        "w": graph.e_w[:E].copy(), "iterations": iterations,
                        "huber_delta": graph.huber_delta, "lam0": graph.lm_lambda0}
                out = solve(iterations)
                if K > 5:
                    self.bench_solves.append(dict(snap, out=np.array(out, copy=True)))
                return out

            graph.optimize = optimize

        def _kf_dispatch(self, k, timestamp, f, Tcw, feats_batch=None, batch_row=0):
            h = super()._kf_dispatch(k, timestamp, f, Tcw, feats_batch, batch_row)
            self.bench_rows[k] = len(h["cands"])
            if k > 0:
                self.bench_t21[k] = (Tcw @ se3.inverse_np(self.store.poses_cw[k - 1])
                                     ).astype(np.float32)
            return h

        def _kf_complete(self, h, blob):
            N = h["N"]
            off = N * (4 if h["bow_on"] else h["nd"] + 8)
            self.bench_track[h["k"]] = np.array(blob[off:off + N], copy=True)
            return super()._kf_complete(h, blob)

        def _close_loop_from_rows(self, k, loop_j, loop_valid, rows):
            self.bench_rows[k] += int(np.sum(loop_valid))
            return super()._close_loop_from_rows(k, loop_j, loop_valid, rows)

        def _verify_candidates(self, cands, f):
            self.bench_reloc_rows.append(len(cands))
            return super()._verify_candidates(cands, f)

    Observed.__name__ = Observed.__qualname__ = base.__name__
    return Observed
