"""Loop-closure modules (codebook, BoW, vocabulary, detector) of
rgbdslam_tpu_torch against rgbdslam_tpu on the same numpy inputs.

Word assignments, trained words and candidate lists are integers and must
be equal; BoW vectors and scores are held to atol 1e-6 (sums of at most a
few hundred f32 terms in [0, 1], in another order).
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbdslam_tpu  # noqa: F401
import rgbdslam_tpu_torch
from rgbdslam_tpu.config import LoopConfig as JLoopConfig
from rgbdslam_tpu.loop import bow as jbow
from rgbdslam_tpu.loop import codebook as jcodebook
from rgbdslam_tpu.loop import vocabulary as jvoc
from rgbdslam_tpu.loop.detector import LoopDetector as JLoopDetector
from rgbdslam_tpu_torch import convert
from rgbdslam_tpu_torch.config import LoopConfig
from rgbdslam_tpu_torch.loop import bow as tbow
from rgbdslam_tpu_torch.loop import codebook as tcodebook
from rgbdslam_tpu_torch.loop import vocabulary as tvoc
from rgbdslam_tpu_torch.loop.detector import LoopDetector
from rgbdslam_tpu_torch.ops import hamming as thamming
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _clustered_descriptors(rng, n, centers=24, flip=0.06):
    """(n, 8) uint32 descriptors around `centers` random 256-bit centres."""
    c = rng.integers(0, 2, size=(centers, 256)).astype(bool)
    bits = c[rng.integers(0, centers, n)] ^ (rng.uniform(size=(n, 256)) < flip)
    return np.packbits(bits.reshape(n, 8, 32)[..., ::-1], axis=-1).view(">u4")[..., 0].astype(
        np.uint32)


def _shipped():
    d = np.load(tvoc.shipped_vocabulary("svo_fast"))
    return d["words"], d["idf"]


def test_vocabulary_copy_is_byte_equal():
    j, t = jvoc.shipped_vocabulary("svo_fast"), tvoc.shipped_vocabulary("svo_fast")
    assert os.path.dirname(t).startswith(os.path.dirname(rgbdslam_tpu_torch.__file__))
    assert filecmp.cmp(j, t, shallow=False)
    assert tvoc.shipped_vocabulary("sift") is None


def test_vocabulary_load_and_save_roundtrip(tmp_path):
    words_j, idf_j = jvoc.load_vocabulary(jvoc.shipped_vocabulary("svo_fast"))
    words_t, idf_t = tvoc.load_vocabulary(tvoc.shipped_vocabulary("svo_fast"), device="cpu")
    assert words_t.dtype == torch.int32 and words_t.shape == (4096, 8)
    np.testing.assert_array_equal(words_t.numpy().view(np.uint32), np.asarray(words_j))
    np.testing.assert_array_equal(idf_t.numpy(), np.asarray(idf_j))
    p = str(tmp_path / "voc.npz")
    tvoc.save_vocabulary(p, words_t[:64], idf_t[:64])
    w2, i2 = jvoc.load_vocabulary(p)                    # the JAX package reads it
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(words_j)[:64])
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(idf_j)[:64])
    # a float (SIFT/SURF-class) vocabulary loads as f32 rows, as in the JAX
    # package
    fw = np.random.default_rng(3).uniform(size=(4, 128)).astype(np.float32)
    np.savez(str(tmp_path / "f.npz"), words=fw, idf=np.arange(4, dtype=np.float32))
    wf, idf_f = tvoc.load_vocabulary(str(tmp_path / "f.npz"), device="cpu")
    wj, ij = jvoc.load_vocabulary(str(tmp_path / "f.npz"))
    assert wf.dtype == torch.float32
    np.testing.assert_array_equal(wf.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(idf_f.numpy(), np.asarray(ij))


@pytest.mark.parametrize("impl", ["popcount", "matmul"])
def test_hamming_matrix_forms_match(impl):
    rng = np.random.default_rng(0)
    d1 = _clustered_descriptors(rng, 70)
    d2 = _clustered_descriptors(rng, 50)
    ref = np.asarray(jhamming_matrix(d1, d2))
    out = thamming.hamming_distance_matrix(convert.desc_words_from_numpy(d1, device="cpu"),
                                           convert.desc_words_from_numpy(d2, device="cpu"),
                                           impl=impl)
    np.testing.assert_array_equal(out.numpy(), ref)


def jhamming_matrix(d1, d2):
    from rgbdslam_tpu.ops import hamming as jh

    return jh.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2), impl="popcount")


@pytest.mark.parametrize("vocab", ["shipped", "random"])
def test_quantize_and_bow_match(vocab):
    rng = np.random.default_rng(2)
    if vocab == "shipped":
        words, idf = _shipped()
        desc = np.concatenate([words[rng.integers(0, 4096, 300)] ^ np.uint32(1 << 7),
                               _clustered_descriptors(rng, 212)])
    else:
        words = _clustered_descriptors(rng, 128)
        words[5] = words[9]                             # a tie: the lower index wins
        idf = rng.uniform(0.0, 3.0, 128).astype(np.float32)
        desc = _clustered_descriptors(rng, 512)
    valid = rng.uniform(size=len(desc)) > 0.15
    wt, it = convert.vocabulary_from_numpy(words, idf, device="cpu")
    dt, vt = convert.desc_words_from_numpy(desc, device="cpu"), torch.from_numpy(valid)
    aj = np.asarray(jcodebook.quantize(jnp.asarray(desc), jnp.asarray(words), jnp.asarray(valid)))
    at = tcodebook.quantize(dt, wt, vt)
    assert at.dtype == torch.int32
    np.testing.assert_array_equal(at.numpy(), aj)
    vj = np.asarray(jbow.bow_vector(jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(words),
                                    jnp.asarray(idf)))
    vtv = tbow.bow_vector(dt, vt, wt, it)
    np.testing.assert_allclose(vtv.numpy(), vj, rtol=0, atol=1e-6)
    assert abs(float(vtv.abs().sum()) - 1.0) < 1e-5
    db = rng.uniform(size=(40, len(idf))).astype(np.float32)
    db /= db.sum(axis=1, keepdims=True)
    db[3] = vj
    sj = np.asarray(jbow.bow_scores(jnp.asarray(vj), jnp.asarray(db)))
    st = tbow.bow_scores(vtv, torch.from_numpy(db))
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-6)
    assert int(st.argmax()) == 3
    # float descriptors against float words: squared L2, as the JAX package
    fd = rng.uniform(size=(64, 128)).astype(np.float32)
    fwords = rng.uniform(size=(16, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        tcodebook.quantize(torch.from_numpy(fd), torch.from_numpy(fwords),
                           torch.from_numpy(valid[:64])).numpy(),
        np.asarray(jcodebook.quantize(jnp.asarray(fd), jnp.asarray(fwords),
                                      jnp.asarray(valid[:64]))))


def test_train_codebook_matches():
    """k-majority training is deterministic in both packages: the same
    seeds, assignments and majority words, bit for bit."""
    rng = np.random.default_rng(4)
    desc = _clustered_descriptors(rng, 600, centers=20)
    valid = rng.uniform(size=600) > 0.1
    wj, ij = jcodebook.train_codebook(jnp.asarray(desc), jnp.asarray(valid), 32, 4)
    wt, it = tcodebook.train_codebook(convert.desc_words_from_numpy(desc, device="cpu"),
                                      torch.from_numpy(valid), 32, 4)
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), np.asarray(wj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preload", [False, True])
def test_loop_detector_candidates_match(preload, tmp_path):
    """The same keyframes through both detectors: equal BoW tables
    (atol 1e-6) and equal candidate lists for every keyframe."""
    rng = np.random.default_rng(6)
    K = 22
    places = [_clustered_descriptors(rng, 256, centers=12) for _ in range(6)]
    descs, valids, conns = [], [], []
    for k in range(K):
        base = places[(k // 2) % 6].copy()
        flip = rng.uniform(size=256) < 0.3
        base[flip] = _clustered_descriptors(rng, int(flip.sum()), centers=40)
        descs.append(base)
        valids.append(rng.uniform(size=256) > 0.1)
        conns.append({k - 1} if k > 0 else set())
    cfg_j = JLoopConfig(id_interval=4, vocab_size=48, vocab_iters=3)
    cfg_t = LoopConfig(id_interval=4, vocab_size=48, vocab_iters=3)
    dj = JLoopDetector(cfg_j, max_keyframes=4, train_after=3)
    dt = LoopDetector(cfg_t, max_keyframes=4, train_after=3, device="cpu")
    if preload:
        wj, ij = jcodebook.train_codebook(jnp.asarray(np.concatenate(descs[:6])),
                                          jnp.asarray(np.concatenate(valids[:6])), 64, 3)
        p = str(tmp_path / "voc.npz")
        jvoc.save_vocabulary(p, wj, ij)
        dj.load_vocabulary(p)
        dt.load_vocabulary(p)
        assert dt.vocab_width == 64 and dt.bow_db.shape[1] == 64
    for d, v, c in zip(descs, valids, conns):
        assert dj.add(d, v, c) == dt.add(d, v, c)
    dj.connect(9, 2)
    dt.connect(9, 2)
    assert dt.count == K and dt.bow_db.shape[0] >= K
    np.testing.assert_array_equal(dt.words.numpy().view(np.uint32), np.asarray(dj.words))
    np.testing.assert_allclose(dt.bow_db[:K], dj.bow_db[:K], rtol=0, atol=1e-6)
    n_with = 0
    for k in range(K):
        cj, ct = dj.candidates(k), dt.candidates(k)
        assert ct == cj, (k, ct, cj)
        n_with += bool(cj)
    assert n_with >= 5                                    # the gates are exercised
    scores = rng.uniform(size=K + 3).astype(np.float32)
    assert dt.candidates(K - 1, scores) == dj.candidates(K - 1, scores)
    k2 = dt.add_precomputed(None, {K - 1})
    assert k2 == dj.add_precomputed(None, {K - 1}) == K
    assert not dt.bow_db[K].any()
