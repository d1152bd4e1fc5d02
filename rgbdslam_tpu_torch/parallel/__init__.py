from rgbdslam_tpu_torch.parallel.dist_ba import (  # noqa: F401
    Mesh,
    distributed_pose_graph_optimize,
    make_mesh,
    shard_edges,
)
