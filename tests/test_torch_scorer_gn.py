"""K3's scorer alone and K5 as their CUDA kernels compute them
(csrc/mahal.cu `mahal_scores_kernel`, csrc/gicp.cu `gicp_gn_kernel`),
modelled step by step in PyTorch and held against the plain versions and
the JAX package's Pallas kernels in interpret mode.

The scorer's model follows the kernel's decomposition: groups of
`scorer_group(...)` hypotheses, `scorer_chunks(N)` chunks of the points (one
block each), a thread adding its points in turn, the xor tree inside a warp, the
warps in order, the chunks in cluster-rank order. Counts are exact; the sum
of m^2 is held as tests/test_torch_ransac.py holds it, rtol 1e-5 on
sqrt(err / count) (the plain version and interpret mode sum in other
orders); against interpret mode, whose XLA code contracts into fused
multiply-adds, a pair whose m^2 lies within 1e-6 of the threshold may count
apart and a sum of under 10 inliers is held at rtol 1e-4 (`_hold_jax`). K5's result layout (H with both
triangles, b, cost, count in one buffer) is unpacked by the wrapper's own
function, fed by the plain sums, and held at tests/test_torch_gicp.py's
tolerances. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401  (pins JAX f32 matmuls)
from rgbdslam_tpu.ops.pallas_kernels import gicp_gn_normal_equations as j_gn
from rgbdslam_tpu.ops.pallas_kernels import mahal_hypothesis_scores as j_mahal
from rgbdslam_tpu_torch.config import RansacConfig
from rgbdslam_tpu_torch.ops import kernels
from rgbdslam_tpu_torch.solvers.ransac_se3 import _sigma_diag, mahalanobis_sq_planes
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TH = 9.0
H100_SMS = 132


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pose(xi):
    """[R | t] (..., 4, 4) f32 from (..., 6) = (t, rotation vector), by
    Rodrigues' formula."""
    xi = np.asarray(xi, dtype=np.float64)
    w = xi[..., 3:]
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    T = np.zeros(w.shape[:-1] + (4, 4))
    T[..., :3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    T[..., :3, 3] = xi[..., :3]
    T[..., 3, 3] = 1.0
    return T.astype(np.float32)


def _scorer_problem(rng, H, N, lead=()):
    """Hypotheses near the true motion (hypothesis 0 is it), points 0.5-4 m
    deep with 20 % invalid slots, Khoshelham covariance diagonals."""
    T_true = _pose(rng.normal(scale=0.05, size=6))
    T_h = _pose(rng.normal(scale=0.05, size=lead + (H, 6))) @ T_true
    T_h[..., 0, :, :] = T_true
    p1 = rng.uniform(-1, 1, lead + (N, 3)).astype(np.float32)
    p1[..., 2] = rng.uniform(0.5, 4.0, lead + (N,))
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + rng.normal(scale=0.005, size=lead + (N, 3))).astype(np.float32)
    valid = rng.uniform(size=lead + (N,)) > 0.2
    s1 = _sigma_diag(torch.from_numpy(p1[..., 2]), RansacConfig()).numpy()
    s2 = _sigma_diag(torch.from_numpy(p2[..., 2]), RansacConfig()).numpy()
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (T_h, p1, p2, s1, s2)] + [valid]


# ---------------------------------------------------------------------------
# a model of mahal_scores_kernel
# ---------------------------------------------------------------------------


def _model_chunk_sum(contrib):
    """(g,) sum of contrib (g, n_chunk) in one block's order: thread t adds
    its points t, t + SCORER_THREADS, ... in turn; a warp adds lanes i and
    i + 16, then + 8, ... + 1 (the xor tree; every lane ends with the same
    bits); the warps' partials are added in warp order."""
    threads = kernels.SCORER_THREADS
    g, n = contrib.shape
    passes = -(-n // threads)
    padded = torch.zeros((g, max(passes, 1) * threads))
    padded[:, :n] = contrib
    acc = torch.zeros((g, threads))
    for k in range(passes):
        acc = acc + padded[:, k * threads:(k + 1) * threads]
    x = acc.reshape(g, threads // 32, 32)
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] + x[..., half:2 * half]
    total = x[:, 0, 0]
    for w in range(1, threads // 32):
        total = total + x[:, w, 0]
    return total


def scorer_model(T_h, p1, p2, s1, s2, valid, th, sms=H100_SMS):
    """(count, sum of m^2) of every hypothesis, batched alike, in the
    kernel's order: per batch entry and group of `scorer_group` hypotheses
    (as on a card of `sms` SMs), the chunk [r span, (r + 1) span) of block r
    (span = ceil(N / chunks)), each block's sum as `_model_chunk_sum`, the
    blocks' sums added in rank order. m^2 is the plain version's (the kernel
    computes it in the same operation order)."""
    batched = T_h.dim() == 4
    if not batched:
        T_h, p1, p2, s1, s2, valid = (x[None] for x in (T_h, p1, p2, s1, s2, valid))
    B, H, N = T_h.shape[0], T_h.shape[1], p1.shape[1]
    chunks = kernels.scorer_chunks(N)
    span = -(-N // chunks)
    group = kernels.scorer_group(H, N, B, sms)
    cnt = torch.zeros((B, H), dtype=torch.int32)
    err = torch.zeros((B, H), dtype=torch.float32)
    for b in range(B):
        for h0 in range(0, H, group):
            hs = slice(h0, min(H, h0 + group))
            m2 = mahalanobis_sq_planes(T_h[b, hs], p1[b], p2[b], s1[b], s2[b])   # (g, N)
            inl = (m2 <= th) & valid[b]
            contrib = torch.where(inl, m2, 0.0)
            parts = [_model_chunk_sum(contrib[:, r * span:min(N, (r + 1) * span)])
                     for r in range(chunks)]
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            cnt[b, hs] = inl.sum(-1).to(torch.int32)
            err[b, hs] = total
    return (cnt, err) if batched else (cnt[0], err[0])


def _hold(cnt, err, cnt_ref, err_ref):
    """Counts exact; sums rtol 1e-5 on sqrt(err / count)."""
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(cnt_ref))
    c = np.maximum(np.asarray(cnt), 1)
    np.testing.assert_allclose(np.sqrt(np.asarray(err) / c), np.sqrt(np.asarray(err_ref) / c),
                               rtol=1e-5)


def _hold_jax(cnt, err, arrays, jc, je):
    """Against the Pallas kernel in interpret mode. XLA's CPU code contracts
    products and sums into fused multiply-adds (ROADMAP "Watch"); the plain
    version and the CUDA kernel do not. An inlier's residual d = R p1 + t -
    p2 cancels (5 mm from 2 m points), so one m^2 can round apart by more
    than 1e-5 relative, and a valid pair whose m^2 lies within 1e-6
    relative of th can fall on the other side of it. Counts are exact on
    every hypothesis without such a pair and within their number elsewhere.
    The sums, where the counts agree (at least 99 % of the hypotheses): rtol
    1e-5 on sqrt(err / count) from 10 inliers on, where the pairs' rounding
    averages out, rtol 1e-4 under 10."""
    T_h, p1, p2, s1, s2, valid = _t(*arrays)
    m2 = mahalanobis_sq_planes(T_h, p1, p2, s1, s2)
    border = (((m2 - TH).abs() <= 1e-6 * TH) & valid[..., None, :]).sum(-1).numpy()
    cnt, err, jc, je = (np.asarray(x) for x in (cnt, err, jc, je))
    apart = np.abs(cnt - jc)
    assert (apart <= border).all()
    assert (apart == 0).mean() >= 0.99
    for few in (False, True):
        keep = (apart == 0) & ((cnt < 10) == few)
        c = np.maximum(cnt[keep], 1)
        np.testing.assert_allclose(np.sqrt(err[keep] / c), np.sqrt(je[keep] / c),
                                   rtol=1e-4 if few else 1e-5)


@pytest.mark.parametrize("N", [0, 1, 300, 1024])
@pytest.mark.parametrize("H", [1, 31, 256])
def test_scorer_model_matches_plain_and_jax(H, N):
    """The model against the plain version and the Pallas kernel (interpret
    mode). The Pallas kernel takes no N = 0 (its wrapper divides by N):
    there the model and the plain version give count 0 and sum 0.0."""
    rng = np.random.default_rng(100 * H + N)
    arrays = _scorer_problem(rng, H, N)
    mc, me = scorer_model(*_t(*arrays), TH)
    pc, pe = kernels.mahal_hypothesis_scores_ref(*_t(*arrays), TH)
    assert mc.shape == (H,) and mc.dtype == torch.int32 and me.dtype == torch.float32
    _hold(mc, me, pc, pe)
    if N == 0:
        assert int(mc.abs().sum()) == 0 and float(me.abs().sum()) == 0.0
        return
    jc, je = j_mahal(*(jnp.asarray(a) for a in arrays), TH, interpret=True)
    _hold_jax(mc, me, arrays, jc, je)
    if N >= 300:
        assert int(mc[0]) > N // 2          # the true motion scores most valid slots


def test_scorer_model_batch_of_13_with_empty_entries():
    """13 problems with two all-invalid entries: the batched model against
    the batched plain version and against the Pallas kernel entry by entry;
    the empty entries score 0 and 0.0; each entry equals the unbatched
    model on it bit for bit (the kernel's decomposition ignores the batch)."""
    rng = np.random.default_rng(13)
    arrays = _scorer_problem(rng, 256, 1024, lead=(13,))
    arrays[5][3] = False
    arrays[5][11] = False
    mc, me = scorer_model(*_t(*arrays), TH)
    pc, pe = kernels.mahal_hypothesis_scores_ref(*_t(*arrays), TH)
    assert mc.shape == (13, 256)
    _hold(mc, me, pc, pe)
    for b in range(13):
        jc, je = j_mahal(*(jnp.asarray(a[b]) for a in arrays), TH, interpret=True)
        _hold_jax(mc[b], me[b], [a[b] for a in arrays], jc, je)
        oc, oe = scorer_model(*_t(*(a[b] for a in arrays)), TH)
        assert torch.equal(oc, mc[b]) and torch.equal(oe, me[b])
    for b in (3, 11):
        assert int(mc[b].sum()) == 0 and float(me[b].abs().sum()) == 0.0
    assert int(mc[0].min()) >= 0 and int(mc[0, 0]) > 500


def test_scorer_model_nan_hypothesis():
    """A NaN pose scores no inlier (every m^2 is NaN) in the model, the
    plain version and the Pallas kernel; the other hypotheses are unmoved."""
    rng = np.random.default_rng(7)
    arrays = _scorer_problem(rng, 31, 300)
    arrays[0][9] = np.nan
    mc, me = scorer_model(*_t(*arrays), TH)
    pc, pe = kernels.mahal_hypothesis_scores_ref(*_t(*arrays), TH)
    jc, je = j_mahal(*(jnp.asarray(a) for a in arrays), TH, interpret=True)
    _hold(mc, me, pc, pe)
    _hold_jax(mc, me, arrays, jc, je)
    assert int(mc[9]) == 0 and float(me[9]) == 0.0 and int(mc[0]) > 150


@pytest.mark.parametrize("N", [0, 1, 127, 128, 300, 1024, 1025, 4097, 8192])
def test_scorer_chunks_cover_every_point_once(N):
    """Block r takes [r span, min(N, (r + 1) span)): the chunks tile the N
    points, at most SCORER_MAX_CHUNKS of them (a cluster), no chunk empty
    once N >= chunks, one pass a thread up to SCORER_THREADS x chunks."""
    chunks = kernels.scorer_chunks(N)
    span = -(-N // chunks)
    assert 1 <= chunks <= kernels.SCORER_MAX_CHUNKS
    seen = np.zeros(N, dtype=int)
    for r in range(chunks):
        lo, hi = r * span, min(N, (r + 1) * span)
        seen[lo:hi] += 1
        assert hi > lo or N < chunks or N == 0
    assert (seen == 1).all()
    if N <= kernels.SCORER_THREADS * kernels.SCORER_MAX_CHUNKS:
        assert span <= kernels.SCORER_THREADS


@pytest.mark.parametrize("B,group", [(1, 4), (13, 8)])
def test_scorer_grid_fills_the_card(B, group):
    """At the smoke's shapes (H = 256, N = 1024) the grid has at least two
    blocks for each of the H100's 132 SMs: groups of 4 unbatched (512
    blocks), of 8 at batch 13 (3,328)."""
    assert kernels.scorer_group(256, 1024, B, H100_SMS) == group
    blocks = -(-256 // group) * kernels.scorer_chunks(1024) * B
    assert blocks >= 2 * H100_SMS


def test_scorer_wrapper_takes_cuda_tensors_only():
    rng = np.random.default_rng(1)
    args = _t(*_scorer_problem(rng, 8, 64))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mahal_hypothesis_scores(*args, TH)
    assert kernels.LAUNCHES["mahal_hypothesis_scores"] == 0


# ---------------------------------------------------------------------------
# K5's result layout
# ---------------------------------------------------------------------------


def _gicp_problem(seed, N):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] += 2.5
    T = _pose(rng.normal(scale=0.03, size=6))
    p2 = (p1 @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=0.004, size=(N, 3))).astype(np.float32)
    A = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C1 = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    B = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C2 = B @ B.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    valid = rng.uniform(size=N) > 0.2
    T0 = _pose(rng.normal(scale=0.02, size=6)) @ T
    return T0, p1, p2, C1, C2, valid


def _tri6(i, j):
    return i * 6 - i * (i - 1) // 2 + (j - i)


def k5_epilogue(sums):
    """The 44 words gicp_gn_kernel writes from its 29 sums (21 upper-
    triangular H entries, 6 of b, cost, count): word w < 36 is H[w // 6][w %
    6], taken from the upper triangle's sum for both (i, j) and (j, i); words
    36-43 are b, cost and count (sums 21-28)."""
    out = torch.full((44,), float("nan"))
    for w in range(44):
        i, j = divmod(w, 6)
        source = 21 + (w - 36) if w >= 36 else _tri6(min(i, j), max(i, j))
        out[w] = sums[source]
    return out


@pytest.mark.parametrize("seed,N,md", [(3, 256, 0.15), (8, 1024, 0.07), (9, 64, 0.1)])
def test_k5_result_layout_matches_pallas_kernel(seed, N, md):
    """The plain version's 29 sums written in the kernel's layout and
    unpacked by the wrapper's own `gicp_gn_result`: H equal to H^T bit for
    bit and its upper triangle the sums'; against the Pallas kernel (interpret mode) H
    and b rtol 1e-5 and atol 1e-5 x max|H|, the cost rtol 1e-4, the count
    exact (tests/test_torch_gicp.py's tolerances)."""
    arrays = _gicp_problem(seed, N)
    pH, pb, pc, pn = kernels.gicp_gn_normal_equations_ref(*_t(*arrays), md)
    iu = torch.triu_indices(6, 6)
    sums = torch.cat([pH[iu[0], iu[1]], pb, pc[None], pn[None]])
    out = k5_epilogue(sums)
    H, b, cost, cnt = kernels.gicp_gn_result(out)
    assert H.shape == (6, 6) and b.shape == (6,) and cost.dim() == 0 and cnt.dim() == 0
    assert H.data_ptr() == out.data_ptr()                     # views, no copy
    assert torch.equal(H, H.T)
    assert torch.equal(torch.triu(H), torch.triu(pH))
    Hj, bj, cj, nj = j_gn(*(jnp.asarray(a) for a in arrays), md, interpret=True)
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(cost), float(cj), rtol=1e-4)
    assert int(cnt) == int(nj) and 0 < int(cnt) <= int(arrays[5].sum())
