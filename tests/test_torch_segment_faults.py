"""A fault of the segment solver that the port shares with the JAX package
(ROADMAP C): on the BA benchmark's monocular problem, segment BA ends far
above the joint optimum in both packages. The problem is the benchmark's at P=64, L=4096
(torch_segment_cases.py's "benchmark" case; chip_smoke.py phase 11 (b) runs
it at P=500, L=100k on the card).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_segment_cases import run  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import make_problem  # noqa: E402

P, L = 64, 4096


def test_segments_on_the_monocular_benchmark_problem_miss_the_joint_optimum_in_both_packages():
    """Both packages' segment runs end above 10x the port's joint dense
    optimum with an ATE above 10x the joint solve's (measured on the CPU: the
    JAX package 592,660 and 0.853 m, the port 265,879 and 0.784 m with 8
    threads, the joint dense solve 1,694 and 0.016 m; the port's monocular
    path moves with the thread count's summation order), each history
    monotone."""
    import numpy as np

    ours, theirs = run("benchmark", P, L, "port"), run("benchmark", P, L, "jax")
    problem, gt_t, _ = make_problem(P, L, 5, return_gt=True, clean=True, device="cpu")
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3))
    joint, info = optimize(problem, cam=cam, solver=BASolverConfig(max_iterations=25, schur_solver="dense"))
    joint_ate = ate_rmse(joint.poses_t.numpy(), gt_t)
    for r in (ours, theirs):
        assert r["cost"] > 10 * info["cost"] and r["ate"] > 10 * joint_ate, r
        assert all(b <= a + 1e-6 for a, b in zip(r["history"][:-1], r["history"][1:])), r
