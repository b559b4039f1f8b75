"""Feature ops: the CUDA kernels and their plain versions, FAST, BRIEF, matching.

The package exports the reference's twelve op names. Importing it builds and
loads no kernel: ops/_build.py builds the library at the first launch.
"""

from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur
from vision_slam_frontend_tpu_torch.ops.fast import fast_scores, fast_detect
from vision_slam_frontend_tpu_torch.ops.brief import (
    brief_pattern,
    compute_orientations,
    brief_describe,
    pack_bits,
    unpack_bits,
)
from vision_slam_frontend_tpu_torch.ops.hamming import (
    hamming_distance_matrix,
    knn2_match,
    ratio_test_match,
    best_percent_mask,
)

__all__ = [
    "gaussian_blur",
    "fast_scores",
    "fast_detect",
    "brief_pattern",
    "compute_orientations",
    "brief_describe",
    "pack_bits",
    "unpack_bits",
    "hamming_distance_matrix",
    "knn2_match",
    "ratio_test_match",
    "best_percent_mask",
]
