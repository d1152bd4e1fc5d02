"""Binary descriptor codebook: quantization and k-majority training (port
of rgbdslam_tpu/loop/codebook.py, binary branch; it stands in for the DBoW3
vocabulary of main.cpp:15,32).

A flat codebook of V binary words: descriptors are assigned to the nearest
word by Hamming distance; training recomputes each word as the per-bit
majority of its cluster (binary k-means). Float descriptor families
(SIFT/SURF-class) are not yet ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbdslam_tpu_torch.ops import hamming


def quantize(desc: torch.Tensor, words: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-word ids (N,) int32 for descriptors (N, 8) against words
    (V, 8), both int32 bit patterns; the lowest word index wins a tie, and
    an invalid descriptor gets word 0."""
    if desc.dtype.is_floating_point or words.dtype.is_floating_point:
        raise NotImplementedError("float vocabularies are not yet ported")
    d = hamming.hamming_distance_matrix(desc, words, valid1=valid, impl="matmul")
    return torch.argmin(d, dim=1).to(torch.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, 256) bool -> (V, 8) int32 words, least significant bit first."""
    b = bits.reshape(bits.shape[0], 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = torch.sum(b << shifts, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _word_counts(assign: torch.Tensor, weight: torch.Tensor, v: int) -> torch.Tensor:
    return torch.zeros((v,), dtype=torch.float32, device=assign.device).index_add_(
        0, assign.long(), weight)


def train_codebook(desc: torch.Tensor, valid: torch.Tensor,
                   vocab_size: int = 1024, iters: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-majority clustering of training descriptors.

    desc: (N, 8) int32 bit patterns; valid: (N,) bool. Returns (words
    (V, 8) int32, idf (V,) f32); idf from the training corpus's word
    frequencies. Deterministic: maxmin seeding (greedily the valid
    descriptor farthest in Hamming distance from the chosen seeds) and Lloyd
    iterations, no random component."""
    first = torch.argmax(valid.to(torch.int32))

    def dist_to(w):
        return hamming.popcount_rows(desc ^ w[None, :])

    seeds = [desc[first]]
    min_d = dist_to(desc[first])
    for _ in range(vocab_size - 1):
        idx = torch.argmax(torch.where(valid, min_d, -1))
        w = desc[idx]
        seeds.append(w)
        min_d = torch.minimum(min_d, dist_to(w))
    words = torch.stack(seeds)

    bits = hamming.unpack_bits(desc)                       # (N, 256)
    wmask = valid.to(torch.float32)
    for _ in range(iters):
        assign = quantize(desc, words, valid).long()
        counts = _word_counts(assign, wmask, vocab_size)
        bit_sums = torch.zeros((vocab_size, bits.shape[1]), dtype=torch.float32,
                               device=desc.device).index_add_(0, assign, bits * wmask[:, None])
        new_words = _pack_bits(bit_sums > 0.5 * counts[:, None])
        # empty clusters keep their previous words
        words = torch.where((counts > 0)[:, None], new_words, words)
    df = _word_counts(quantize(desc, words, valid), wmask, vocab_size)
    n_valid = torch.clamp_min(wmask.sum(), 1.0)
    idf = torch.clamp_min(torch.log(n_valid / (1.0 + df)), 0.0)
    return words, idf
