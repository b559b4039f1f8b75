"""Bundle-adjustment backend (port of the JAX package's backend/):
Levenberg-Marquardt with exact Schur elimination of the landmark blocks and
a dense-Cholesky or matrix-free PCG solve of the reduced camera system, on
the device the problem's tensors live on; windowed local BA over the
trailing keyframes; multi-session merging.
"""

from vision_slam_frontend_tpu_torch.backend.tracks import build_ba_problem
from vision_slam_frontend_tpu_torch.backend.ba import (
    BASolverConfig,
    load_solver_checkpoint,
    optimize,
    save_solver_checkpoint,
)
from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, slice_problem, windowed_local_ba
from vision_slam_frontend_tpu_torch.backend.merge import merge_sessions, merge_slam_problems
from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse, rpe_rmse

__all__ = [
    "build_ba_problem",
    "BASolverConfig",
    "optimize",
    "save_solver_checkpoint",
    "load_solver_checkpoint",
    "ate_rmse",
    "rpe_rmse",
    "windowed_local_ba",
    "slice_problem",
    "LocalBAState",
    "merge_sessions",
    "merge_slam_problems",
]
