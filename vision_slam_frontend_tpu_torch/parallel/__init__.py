"""Multi-device bundle adjustment (port of the JAX package's parallel/):
shard groups and process-group setup, observation- and landmark-sharded BA,
segment-parallel BA, the multi-process smoke and the collective report."""

from vision_slam_frontend_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from vision_slam_frontend_tpu_torch.parallel.segment_ba import build_segments, optimize_segments
from vision_slam_frontend_tpu_torch.parallel.sharded_ba import (
    build_lm_sharded,
    optimize_sharded,
    optimize_sharded_dense,
    shard_ba_problem,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "shard_ba_problem",
    "optimize_sharded",
    "optimize_sharded_dense",
    "build_lm_sharded",
    "build_segments",
    "optimize_segments",
]
