"""rgbdslam_tpu_torch — RGB-D SLAM (tracking, keyframes, proximity edges,
BoW loop closure, pose-graph optimization, maps) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `rgbdslam_tpu` (JAX/XLA/Pallas), which stays the reference it is
tested against. The module layout and function names follow the JAX
package, so each counterpart is easy to find; public functions keep its
array layouts ((N, 2) uv, (N, 3) xyz, (N, 8) descriptor words, (4, 4)
poses). Descriptor words are uint32 bits held in torch.int32.

Subpackages:
  geometry  SE(3) math, pinhole RGB-D camera model
  ops       image ops, FAST/Shi-Tomasi detection, BRIEF, Hamming, and the
            CUDA kernel wrappers (ops/kernels.py, sources in csrc/)
  frontend  extractor, per-frame feature build + matching
  solvers   Horn fit, Mahalanobis RANSAC, plane-to-plane GICP, pose-graph
            Levenberg-Marquardt (dense and matrix-free CG)
  mapping   keyframe and landmark stores, covisibility (host numpy),
            keyframe clouds and the occupancy grid
  loop      binary codebook, BoW vectors, loop-candidate detection
  slam      Tracker, SlamSystem (serial, ring and batched full SLAM),
            PipelinedOdometry
  io        synthetic renderer (box room, multi-room), TUM/ICL/CoRBS
            datasets, PNG read/write, TUM trajectory files
  native    the C++ prefetching PNG loader (ctypes)
  utils     map checkpoints (npz), stage timers and traces
  viz       PLY / HTML / plot exports, the octomap rebuild
  eval      ATE/RPE
"""

__version__ = "0.1.0"

import torch as _torch

# The Horn fit and the 6x6 Gauss-Newton solves need true f32 products:
# TF32 keeps ~3 decimal digits and breaks pose estimation (the JAX package
# pins f32 matmul precision for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
