"""Descriptor codebooks: quantization, k-majority training for binary
descriptors and Lloyd k-means for float ones (port of
rgbdslam_tpu/loop/codebook.py; they stand in for the DBoW3 vocabulary of
main.cpp:15,32).

A flat codebook of V words: binary descriptors are assigned to the nearest
word by Hamming distance and training recomputes each word as the per-bit
majority of its cluster (binary k-means); float (SIFT/SURF-class)
descriptors by squared L2 distance, each word the mean of its cluster.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbdslam_tpu_torch.ops import hamming


def quantize(desc: torch.Tensor, words: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-word ids (N,) int32 for descriptors against words: (N, 8)
    against (V, 8) int32 bit patterns by Hamming distance, or (N, D) against
    (V, D) f32 by squared L2 distance (|w|^2 - 2 x.w, one matmul); the
    lowest word index wins a tie, and an invalid descriptor gets word 0."""
    if desc.dtype.is_floating_point:
        d = (torch.sum(words * words, dim=-1)[None, :]
             - 2.0 * (desc @ words.T))
        if valid is not None:
            d = torch.where(valid[:, None], d, float("inf"))
        return torch.argmin(d, dim=1).to(torch.int32)
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


def train_codebook_float(desc: torch.Tensor, valid: torch.Tensor,
                         vocab_size: int = 1024, iters: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic Lloyd k-means for float descriptors (N, D) f32: maxmin
    seeding by squared L2 distance, then `iters` rounds of assignment and
    cluster means (one-hot products, as the JAX package forms them; an empty
    cluster keeps its word). Returns (words (V, D) f32, idf (V,) f32) like
    `train_codebook`."""
    first = torch.argmax(valid.to(torch.int32))

    def d2_to(w):
        diff = desc - w[None, :]
        return torch.sum(diff * diff, dim=-1)

    seeds = [desc[first]]
    min_d = d2_to(desc[first])
    for _ in range(vocab_size - 1):
        idx = torch.argmax(torch.where(valid, min_d, -1.0))
        w = desc[idx]
        seeds.append(w)
        min_d = torch.minimum(min_d, d2_to(w))
    words = torch.stack(seeds)
    wmask = valid.to(torch.float32)

    def onehot(assign):
        return (torch.nn.functional.one_hot(assign.long(), vocab_size).to(torch.float32)
                * wmask[:, None])

    for _ in range(iters):
        oh = onehot(quantize(desc, words, valid))
        counts = oh.sum(dim=0)
        new_words = (oh.T @ desc) / torch.clamp_min(counts, 1.0)[:, None]
        words = torch.where((counts > 0)[:, None], new_words, words)
    df = onehot(quantize(desc, words, valid)).sum(dim=0)
    n_valid = torch.clamp_min(wmask.sum(), 1.0)
    idf = torch.clamp_min(torch.log(n_valid / (1.0 + df)), 0.0)
    return words, idf
