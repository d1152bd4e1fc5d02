"""Vocabulary persistence and offline training (port of
rgbdslam_tpu/loop/vocabulary.py): the shipped codebook artifacts, npz
load/save, and the training entry point

  python -m rgbdslam_tpu_torch.loop.vocabulary --dataset synthetic:orbit \
      --detector orb --out voc.npz [--device cpu]

Binary words are stored as uint32 and held as int32 bit patterns, like
every binary descriptor in this package; float (SIFT/SURF-class) words are
f32 rows. A file saved by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rgbdslam_tpu_torch.device import resolve_device, upload
from rgbdslam_tpu_torch.frontend.frame import to_device_rows, to_host_rows

#: shipped vocabulary artifacts by detector (the reference's
#: voc_TUM_FAST_BRIEF.yml.gz analog, main.cpp:15), trained offline over
#: synthetic worlds; the other variants train their codebook online
_SHIPPED = {
    "svo_fast": "voc_synth_fast_brief.npz",
    "fast": "voc_synth_fast_brief.npz",
    "brief": "voc_synth_fast_brief.npz",
    "orb": "voc_synth_orb.npz",
    "orb2": "voc_synth_orb.npz",
}


def shipped_vocabulary(detector: str) -> Optional[str]:
    """Path of the shipped vocabulary matching a detector's descriptor
    family, or None if no artifact fits."""
    name = _SHIPPED.get(detector)
    if name is None:
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", name)
    return path if os.path.exists(path) else None


def save_vocabulary(path: str, words, idf) -> None:
    np.savez_compressed(path, words=to_host_rows(torch.as_tensor(words)),
                        idf=torch.as_tensor(idf).cpu().numpy())


def load_vocabulary(path: str, device="cuda"):
    """(words, idf (V,) f32) on `device` (the card unless the caller asks
    for the CPU): words (V, 8) int32 bit patterns of a binary vocabulary, or
    (V, D) f32 of a float one."""
    device = resolve_device(device)
    with np.load(path) as d:
        words, idf = np.asarray(d["words"]), np.asarray(d["idf"], dtype=np.float32)
    return to_device_rows(words, device), torch.as_tensor(idf, device=device)


def collect_descriptors(dataset, cam, extractor_cfg, frame_stride: int = 5,
                        max_frames: int = 40, detector: str = "svo_fast", device="cuda"):
    """Run the extractor over a dataset on `device` (the card unless the
    caller asks for the CPU); returns host (desc, valid): uint32 words of a
    binary family, f32 rows of a float one."""
    from rgbdslam_tpu_torch.frontend.extractor import Extractor

    dev = resolve_device(device)
    ex = Extractor(cam, extractor_cfg, detector=detector)
    descs, valids = [], []
    n = min(len(dataset), max_frames * frame_stride)
    for i in range(0, n, frame_stride):
        _ts, gray, depth = dataset.grab(i)
        f = ex(upload(gray, dev), upload(depth, dev))
        descs.append(to_host_rows(f.desc))
        valids.append(f.valid.cpu().numpy())
    return np.concatenate(descs), np.concatenate(valids)


def train_from_descriptors(desc: np.ndarray, valid: np.ndarray, vocab_size: int = 1024,
                           iters: int = 8, device="cuda"):
    """A codebook from host descriptors on `device` (the card unless the
    caller asks for the CPU): k-majority for uint32 words, L2 k-means for
    float rows. Returns (words, idf) on `device`."""
    from rgbdslam_tpu_torch.loop.codebook import train_codebook, train_codebook_float

    dev = resolve_device(device)
    d = to_device_rows(desc, dev)
    v = torch.as_tensor(np.asarray(valid, bool), device=dev)
    return (train_codebook if d.dtype == torch.int32 else train_codebook_float)(
        d, v, vocab_size, iters)


def train_vocabulary_from_dataset(dataset, cam, extractor_cfg, vocab_size: int = 1024,
                                  iters: int = 8, frame_stride: int = 5,
                                  max_frames: int = 40, detector: str = "svo_fast",
                                  device="cuda") -> tuple:
    """Run the extractor over a dataset and train a codebook on its
    descriptors (the DBoW3 offline-vocabulary workflow), on `device` (the
    card unless the caller asks for the CPU). Training is deterministic."""
    desc, valid = collect_descriptors(dataset, cam, extractor_cfg, frame_stride, max_frames,
                                      detector=detector, device=device)
    return train_from_descriptors(desc, valid, vocab_size, iters, device=device)


def main(argv=None) -> int:
    """CLI: python -m rgbdslam_tpu_torch.loop.vocabulary --dataset ... --out voc.npz"""
    import argparse

    ap = argparse.ArgumentParser(description="train a loop-closure vocabulary")
    ap.add_argument("--dataset", required=True, nargs="+",
                    help="one or more datasets; descriptors are pooled (synthetic "
                         "specs accept :trajectory:seed:noise suffixes, e.g. "
                         "synthetic:orbit:3:noise)")
    ap.add_argument("--kind", default="TUM")
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab-size", type=int, default=1024)
    ap.add_argument("--detector", default="svo_fast",
                    help="extractor variant whose descriptors to train on")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--width", type=int, default=None,
                    help="synthetic image width (default 640); the intrinsics scale with it")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from rgbdslam_tpu_torch.config import ExtractorConfig
    from rgbdslam_tpu_torch.device import resolve_device
    from rgbdslam_tpu_torch.io.datasets import open_dataset
    from rgbdslam_tpu_torch.io.synthetic import SyntheticDataset

    from rgbdslam_tpu_torch.cli import _camera

    device = resolve_device(args.device)
    cam = _camera(args)
    descs, valids = [], []
    for spec in args.dataset:
        if spec.startswith("synthetic"):
            parts = spec.split(":")
            ds = SyntheticDataset(n_frames=args.frames * args.stride, cam=cam,
                                  trajectory=parts[1] if len(parts) > 1 else "orbit",
                                  seed=int(parts[2]) if len(parts) > 2 else 0,
                                  noise=len(parts) > 3 and parts[3] == "noise",
                                  device=device)
        else:
            ds = open_dataset(spec, kind=args.kind)
        d, v = collect_descriptors(ds, ds.cam, ExtractorConfig(), args.stride, args.frames,
                                   detector=args.detector, device=device)
        descs.append(d)
        valids.append(v)
        print(f"{spec}: {int(v.sum())} descriptors")
    desc, valid = np.concatenate(descs), np.concatenate(valids)
    words, idf = train_from_descriptors(desc, valid, args.vocab_size, 8, device=device)
    save_vocabulary(args.out, words, idf)
    print(f"saved {args.vocab_size}-word vocabulary to {args.out} "
          f"({int(valid.sum())} training descriptors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
