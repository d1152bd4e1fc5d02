"""Loop-closure candidate detection with the reference's gating semantics
(port of rgbdslam_tpu/loop/detector.py).

Mirrors LoopDetector::obtainCandidates (PlaceRecognition/LoopDetector.cpp:28-84):
- the similarity floor is the minimum BoW score between the query and its
  directly connected keyframes (LoopDetector.cpp:37-46);
- candidates must not be connected to the query, must beat the floor, and
  must be at least `interval` keyframe ids away (System/Tracking.cpp:29);
- the top `max_candidates` (5) by score (LoopDetector.cpp:78-81).

The BoW database is a dense (K, V) host matrix (loop/bow.py); the gates are
boolean masks. Without a loaded vocabulary the codebook trains on the
descriptors of the first `train_after` keyframes.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from rgbdslam_tpu_torch.config import LoopConfig
from rgbdslam_tpu_torch.device import resolve_device
from rgbdslam_tpu_torch.frontend.frame import to_device_rows
from rgbdslam_tpu_torch.loop.bow import bow_scores, bow_vector
from rgbdslam_tpu_torch.loop.codebook import train_codebook, train_codebook_float


class LoopDetector:
    def __init__(self, cfg: LoopConfig = LoopConfig(), max_keyframes: int = 512,
                 train_after: int = 5, seed: int = 0, device="cuda"):
        # `seed` kept for API parity; codebook training is deterministic
        self.cfg = cfg
        self.train_after = train_after
        self.device = resolve_device(device)
        self.words: Optional[torch.Tensor] = None     # (V, 8) int32 or (V, D) f32
        self.idf: Optional[torch.Tensor] = None       # (V,) f32 on `device`
        self.bow_db = np.zeros((max_keyframes, cfg.vocab_size), dtype=np.float32)
        self.count = 0
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []  # (desc, valid)
        self._connections: List[Set[int]] = []

    # ------------------------------------------------------------------
    @property
    def vocab_width(self) -> int:
        """The one source of every BoW table's width: the loaded or trained
        codebook's word count, the configured size before one exists."""
        if self.idf is not None:
            return int(self.idf.shape[0])
        return self.cfg.vocab_size

    def _bow_row(self, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
        v = torch.as_tensor(np.asarray(valid, dtype=bool), device=self.device)
        return bow_vector(to_device_rows(desc, self.device), v, self.words,
                          self.idf).cpu().numpy()

    def _backfill(self) -> None:
        for k, (d, v) in enumerate(self._pending):
            self.bow_db[k] = self._bow_row(d, v)

    def load_vocabulary(self, path: str) -> None:
        """Use a pre-trained codebook (the reference's startup vocabulary
        load, main.cpp:32) instead of on-the-fly training."""
        from rgbdslam_tpu_torch.loop.vocabulary import load_vocabulary

        self.words, self.idf = load_vocabulary(path, device=self.device)
        if self.bow_db.shape[1] != self.vocab_width:
            self.bow_db = np.zeros((self.bow_db.shape[0], self.vocab_width), np.float32)
        self._backfill()      # keyframes registered before the load

    def _train(self) -> None:
        desc = np.concatenate([d for d, _ in self._pending], axis=0)
        valid = np.concatenate([v for _, v in self._pending], axis=0)
        # binary families train a k-majority codebook, float (SIFT/SURF)
        # families an L2 k-means one: every family keeps loop closure
        train = train_codebook if desc.dtype == np.uint32 else train_codebook_float
        self.words, self.idf = train(to_device_rows(desc, self.device),
                                     torch.as_tensor(valid, device=self.device),
                                     self.cfg.vocab_size, self.cfg.vocab_iters)
        self._backfill()

    def _ensure_capacity(self, k: int) -> None:
        """Double the dense BoW table when full."""
        if k >= self.bow_db.shape[0]:
            self.bow_db = np.concatenate([self.bow_db, np.zeros_like(self.bow_db)], axis=0)

    def add(self, desc: np.ndarray, valid: np.ndarray, connections: Set[int]) -> int:
        """Register keyframe `count` (host descriptors: uint32 words or f32) with
        its direct connections (LoopDetector::add + Frame::mspConnectedKFs)."""
        k = self.count
        self._ensure_capacity(k)
        self._pending.append((np.asarray(desc), np.asarray(valid)))
        self._connections.append(set(connections))
        self.count += 1
        if self.words is None:
            if self.count >= self.train_after:
                self._train()
        else:
            self.bow_db[k] = self._bow_row(desc, valid)
        return k

    def add_precomputed(self, vec, connections: Set[int]) -> int:
        """Register keyframe `count` whose BoW vector was quantized on the
        device. `vec=None`: the vector stays in the device bank and the host
        row is zero until SlamSystem.hydrate_host backfills it."""
        k = self.count
        self._ensure_capacity(k)
        self._connections.append(set(connections))
        if vec is not None:
            self.bow_db[k] = vec
        self.count += 1
        return k

    def connect(self, a: int, b: int) -> None:
        """Record a direct keyframe connection (Frame::addConnection)."""
        if a < self.count and b < self.count:
            self._connections[a].add(b)
            self._connections[b].add(a)

    # ------------------------------------------------------------------
    def candidates(self, k: int, scores: Optional[np.ndarray] = None) -> List[int]:
        """Loop candidates for keyframe k (obtainCandidates semantics).
        `scores` may carry precomputed BoW scores of k against the database
        (>= count entries); otherwise they are computed here."""
        if self.words is None or self.count < 2:
            return []
        conn = self._connections[k]
        if not conn:
            return []
        if scores is None:
            scores = bow_scores(torch.as_tensor(self.bow_db[k]),
                                torch.as_tensor(self.bow_db[: self.count])).numpy()
        else:
            scores = np.asarray(scores)[: self.count]
        conn_idx = [c for c in conn if c != k and c < self.count]
        if not conn_idx:
            return []
        min_score = float(np.min(scores[conn_idx]))  # LoopDetector.cpp:37-46

        ids = np.arange(self.count)
        mask = ((scores > min_score) & (np.abs(ids - k) > self.cfg.id_interval)
                & (ids != k))
        for c in conn:
            if c < self.count:
                mask[c] = False
        cand = ids[mask]
        if len(cand) == 0:
            return []
        order = np.argsort(-scores[cand])
        return cand[order][: self.cfg.max_candidates].tolist()
