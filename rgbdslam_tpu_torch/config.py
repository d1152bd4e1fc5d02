"""Configuration dataclasses, field for field the same as rgbdslam_tpu.config.

The reference has no config system — every knob is a hardcoded constant
(SURVEY.md §5.6). Here each constant is a field with its reference citation so
parity can be checked line by line. Plain frozen dataclasses with no torch
dependency; `convert.config_from_jax` maps the JAX package's configs onto
these. Fields of features the port does not run yet (ADAPTIVE mode, the
other detectors, the backend) are kept so both packages read one config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """Feature detection/description budget.

    Reference: Features/Extractor.cpp:21 (nfeatures=1000, scale=1.2, 8 levels,
    FAST th 20/7), Features/SVOextractor.cpp:9-13 (SVO: levels, cell size,
    threshold), main.cpp:31 (the live path uses the SVO detector + BRIEF).
    """

    num_features: int = 1024          # fixed slot budget (reference: 1000, padded to a lane multiple)
    num_levels: int = 4               # pyramid levels (SVOextractor default 3+1; main.cpp uses default)
    scale_factor: float = 2.0         # pyramid scale step: 2.0 = the SVO
                                      # half-sample path (live default,
                                      # Features/SVOextractor.cpp:135-144);
                                      # 1.2 + num_levels=8 = the ORBextractor
                                      # scale space with per-level quotas
                                      # (Features/Extractor.cpp:21,
                                      # ORBextractor.cpp:347-419,773-797)
    cell_size: int = 16               # grid cell for best-per-cell NMS (reference SVO: 5*2^?; tuned for budget)
    fast_threshold: float = 20.0      # FAST threshold (Features/SVOextractor.cpp:101, mThresh)
    min_response: float = 20.0        # final Shi-Tomasi response gate (Features/SVOextractor.cpp:128)
    min_border: int = 16              # keep keypoints at least this far from the image edge
    brief_patch_size: int = 31        # BRIEF/ORB sampling patch (Features/ORBextractor.cpp pattern)
    orientation_radius: int = 15      # intensity-centroid radius (Features/ORBextractor.cpp:16-41)
    # subpixel quadratic refinement of corner positions (beyond the
    # reference). Off by default: on this detector the Shi-Tomasi peak
    # offset is viewpoint-dependent, which trades unbiased +-0.5 px
    # quantization noise (averaged out by 500-match RANSAC) for a small
    # correlated drift — a net loss for clean VO, a win only when depth
    # noise dominates.
    subpixel: bool = False
    # ADAPTIVE-mode target band + threshold clamps (DetectorAdjuster /
    # createAdaptiveDetector: 600-1020 features, Features/Extractor.cpp:95;
    # the x0.7/x1.3 feedback lives in DetectorAdjuster.cpp:45-57). In the
    # batched tracking scan this band is compiled into the on-device
    # feedback, so it is config, not per-Extractor-instance, state.
    adapt_target_min: int = 600
    adapt_target_max: int = 1020
    adapt_th_min: float = 3.0
    adapt_th_max: float = 80.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching.

    Reference: Features/Matcher.cpp:9-11 (TH_HIGH=100, TH_LOW=50),
    System/Tracking.cpp:125 (ratio 0.9), Matcher.cpp:106-139 (kNN2 + ratio +
    train dedup + validity gates).
    """

    nn_ratio: float = 0.9
    th_high: int = 100
    th_low: int = 50


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched 3D-3D RANSAC rigid registration.

    Reference: Solver/SolverSE3.cpp:10-13 (iters=200, minInliers=20, maxMahal=3,
    sample=4); System/Tracking.cpp:129 uses minInliers=10 for VO. The reference
    runs <=200 sequential iterations with early exit; on TPU we evaluate a fixed
    batch of hypotheses in parallel plus a fixed number of refinement rounds
    (Solver/SolverSE3.cpp:61-84's refine-until-stable loop becomes
    `refine_iters` masked re-fits).
    """

    num_hypotheses: int = 256         # parallel hypotheses (reference: 200 sequential w/ early exit)
    sample_size: int = 4              # Solver/SolverSE3.cpp:13
    min_inliers: int = 10             # System/Tracking.cpp:129
    max_mahalanobis: float = 3.0      # Solver/SolverSE3.cpp:12
    refine_iters: int = 4             # inner refinement re-fits (reference: <=20, converges in ~3)
    # anisotropic (Mahalanobis-whitened) Gauss-Newton polish of the winner —
    # beyond the reference's scalar-weighted fit; pays off when depth noise
    # dominates (z >~ 2.5 m). Off by default for strict reference parity.
    mahalanobis_refine: bool = False
    mahalanobis_refine_iters: int = 5
    # Error-model selection — the PUT-style Ransac's 5 models
    # (Solver/Ransac.h:15-19): 'mahalanobis' (the live RansacSE3 model),
    # 'euclidean', 'adaptive_euclidean' (threshold grows with depth,
    # Solver/Ransac.cpp:247-427), 'reprojection', 'both'
    # (euclidean AND reprojection).
    error_model: str = "mahalanobis"
    inlier_threshold_m: float = 0.05      # euclidean threshold
    reproj_threshold_px: float = 3.0      # reprojection threshold
    adaptive_depth_coeff: float = 0.01    # euclidean th += coeff * mean(z)^2
    # RGB-D sensor noise model (Khoshelham), Solver/SolverSE3.cpp:216-297:
    cam_angle_x: float = 58.0         # deg FOV x (Solver/SolverSE3.cpp:218)
    cam_angle_y: float = 45.0         # deg FOV y (Solver/SolverSE3.cpp:219)
    cam_resol_x: int = 640            # Solver/SolverSE3.cpp:220
    cam_resol_y: int = 480            # Solver/SolverSE3.cpp:221
    depth_std_factor: float = 0.01    # sigma_z = c*z^2 (Solver/SolverSE3.cpp:294)
    # NOTE: the reference's depthCovariance caches the covariance of the FIRST
    # depth it ever sees in a function-local `static` (Solver/SolverSE3.cpp:282-287)
    # — an evident bug. We implement the intended per-point model.


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """GICP/point-to-plane refinement over matched keypoint sets.

    Reference: Solver/Gicp.cpp:12-15 (15 iters, 0.08 m correspondence dist)
    overridden by System/Tracking.cpp:148-149 (0.07 m, 10 iters); requires >=20
    matches (Solver/Gicp.cpp:23); triggered when RANSAC rmse >= 0.8
    (System/Tracking.cpp:145).
    """

    max_iterations: int = 10
    max_correspondence_dist: float = 0.07
    min_matches: int = 20
    rmse_trigger: float = 0.8
    gicp_epsilon: float = 1e-3        # covariance regularizer for plane-to-plane weighting
    reassociate: bool = False         # re-pair nearest neighbors within the
                                      # matched sets each GN round (PCL GICP
                                      # re-finds correspondences per
                                      # iteration, Solver/Gicp.cpp:54-66);
                                      # off = keep the descriptor pairing
                                      # (fine with a RANSAC warm start, and
                                      # one N^2 distance matrix cheaper)


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe policy + per-KF cloud pipeline.

    Reference: System/Tracking.cpp:217-218 (0.20 m / 0.1745 rad gate),
    System/Tracking.cpp:234-237 (cloud: stride 6, z in [0.5, 4.0], voxel 0.04 m,
    statistical filter (50, 1.0)).
    """

    min_translation: float = 0.20
    min_rotation: float = 0.1745
    cloud_stride: int = 6
    cloud_z_min: float = 0.5
    cloud_z_max: float = 4.0
    voxel_size: float = 0.04
    sor_neighbors: int = 50
    sor_std_mul: float = 1.0
    max_keyframes: int = 512          # preallocated KF slot budget (device arrays)


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Pose-graph backend.

    Reference: Solver/PoseGraph.cpp:130 (proximity matches >=30),
    PoseGraph.cpp:159 (radius 0.5 m), PoseGraph.cpp:205,226 (info=100*I6, Huber),
    PoseGraph.cpp:71,350-368 (LM 20 iters on loop, 10 default, final at
    shutdown), PoseGraph.cpp:354 (optimize only when >5 vertices).
    """

    proximity_radius: float = 0.50
    proximity_min_matches: int = 30
    max_proximity_candidates: int = 8   # batched candidate budget per new KF
    edge_information: float = 100.0
    huber_delta: float = 1.0
    opt_iters_loop: int = 20
    opt_iters_default: int = 10
    min_vertices: int = 6               # ">5 vertices" (Solver/PoseGraph.cpp:354)
    max_edges: int = 4096               # preallocated edge slots
    lm_lambda0: float = 1e-4
    # above this (padded) vertex count the dense (6K)^2 Cholesky is replaced
    # by the matrix-free block-Jacobi-preconditioned CG solve (solvers/cg.py)
    # so memory/compute stay O(K + E) as the map grows (SURVEY.md §7 layer 7
    # "then Schur/CG"); equivalence is tested in tests/test_pose_graph.py
    cg_vertex_threshold: int = 256
    cg_iters: int = 64                  # inner CG iterations per GN step


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop detection gates.

    Reference: Solver/PoseGraph.cpp:248-251 (>=15 KFs since last loop),
    System/Tracking.cpp:29 (id interval 100), PoseGraph.cpp:268 (match
    threshold 0.2*meanInliers), PlaceRecognition/LoopDetector.cpp:78-81 (top 5),
    LoopDetector.cpp:37-46 (min connected-KF BoW score as floor).
    """

    min_kfs_since_loop: int = 15
    id_interval: int = 100
    match_fraction: float = 0.20
    max_candidates: int = 5
    vocab_size: int = 1024            # binary codebook words (replaces DBoW3 voc)
    vocab_iters: int = 8              # k-majority training iterations


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level configuration bundle."""

    extractor: ExtractorConfig = ExtractorConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    icp: IcpConfig = IcpConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    loop: LoopConfig = LoopConfig()
    use_icp_refinement: bool = True
    # detector variant + ADAPTIVE mode (Features/Extractor.h:13-31 factory)
    detector: str = "svo_fast"        # 'svo_fast' | 'orb' | 'gftt'
    adaptive: bool = False
    # dense projective point-to-plane refinement of every successful VO
    # estimate (solvers/dense_icp.py) — the ICL-NUIM-class dense config
    use_dense_icp: bool = False
    dense_icp_levels: Tuple[int, ...] = (4, 2)
    image_size: Tuple[int, int] = (480, 640)   # (H, W)
    # local landmark-keyframe BA over a sliding window (a capability beyond
    # the reference, SURVEY.md §7 layer 7 / BASELINE config 3)
    use_local_ba: bool = False
    ba_window: int = 5
    ba_iterations: int = 4
    max_landmarks: int = 16384
    max_obs_per_landmark: int = 8
    # global landmark-Schur BA over the whole map after each loop closure
    # and at shutdown (polishes the pose-graph solution; subsumes the pose
    # graph on small maps) — also beyond the reference
    use_global_ba: bool = False
    global_ba_iterations: int = 6
    # edge-factor information scale for joint global BA: the pose-graph
    # info (100*I, Solver/PoseGraph.cpp:205) understates a 500-point RANSAC
    # registration's accuracy (~mm); x1000 => sigma ~ 3 mm, which keeps the
    # drifting landmark tracks from overriding the pairwise constraints
    ba_edge_scale: float = 1000.0
    # landmark-track extension reprojection gate (px): associations worse
    # than this poison the BA observation table
    track_gate_px: float = 3.0
    # LOST -> relocalization (beyond the reference: its LOST state never
    # persists and recover() just holds the reference pose,
    # System/Tracking.cpp:195-199; here `lost_after` consecutive VO failures
    # enter LOST and the system relocalizes against the BoW keyframe
    # database — retrieval per LoopDetector::obtainCandidates, verification
    # per Tracking::correct's RansacSE3 usage, System/Tracking.cpp:165-193)
    use_relocalization: bool = True
    lost_after: int = 3              # consecutive VO failures before LOST
    reloc_min_inliers: int = 20      # RANSAC inliers to accept a candidate
    reloc_max_candidates: int = 3    # top BoW candidates verified per attempt
    # distributed backend: in the JAX package, with more than one device,
    # every live pose-graph solve and global BA rides a 1-D device mesh (the
    # multi-chip analog of the reference's always-on backend thread,
    # Solver/PoseGraph.cpp:59-103). The port runs the plain path on one
    # device and raises with several CUDA devices (ROADMAP item 26).
    distributed: bool = False


DEFAULT_CONFIG = SlamConfig()
