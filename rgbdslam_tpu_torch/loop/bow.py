"""BoW vectors + dense similarity scoring (port of rgbdslam_tpu/loop/bow.py;
it replaces DBoW3's sparse BowVector and inverted file,
PlaceRecognition/LoopDetector.cpp:22-26).

With a flat V-word codebook every keyframe's BoW vector is a dense (V,)
tf-idf histogram, and a query is scored against all keyframes at once.
Score: DBoW3's L1 norm, s(v, w) = 1 - 0.5 * |v/|v|_1 - w/|w|_1|_1 in [0, 1].
"""

from __future__ import annotations

import torch

from rgbdslam_tpu_torch.loop.codebook import quantize


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, words: torch.Tensor,
               idf: torch.Tensor) -> torch.Tensor:
    """tf-idf BoW vector (V,), L1-normalized. The term counts are sums of
    ones, exact whatever the order of the scatter-add."""
    assign = quantize(desc, words, valid).long()
    tf = torch.zeros((words.shape[0],), dtype=torch.float32, device=desc.device)
    tf = tf.index_add_(0, assign, valid.to(torch.float32))
    vec = tf * idf
    return vec / torch.clamp_min(torch.sum(torch.abs(vec)), 1e-12)


def bow_scores(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """L1 similarity of one query (V,) against a database (K, V) -> (K,).
    Both must already be L1-normalized (bow_vector output)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(query[None, :] - database), dim=-1)
