"""The port's optimize against the JAX package's on tests/test_backend.py's
problems, on the CPU: the final cost and ATE against the JAX run's, and that
file's own assertions on the port's result. Helpers and conventions:
tests/test_torch_backend.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_backend import synthetic_ba  # noqa: E402
from tests.test_torch_backend import port_cam, port_problem  # noqa: E402
from vision_slam_frontend_tpu.backend import ba as jba  # noqa: E402
from vision_slam_frontend_tpu.backend import metrics as jmetrics  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import metrics  # noqa: E402


BACKEND_CASES = {
    # name: (synthetic_ba kwargs, solver kwargs), tests/test_backend.py's
    "zero_noise": (dict(), dict(max_iterations=3)),
    "cost_monotone": (dict(pose_noise=0.05, lm_noise=0.2, seed=4), dict()),
    "landmark_noise": (dict(lm_noise=0.3, seed=1), dict()),
    "pose_and_landmark_noise": (dict(pose_noise=0.08, lm_noise=0.3, px_noise=0.3, seed=2), dict()),
    "huber_outliers": (dict(pose_noise=0.05, lm_noise=0.2, px_noise=0.3, outlier_frac=0.1, seed=3),
                       dict(huber_delta=3.0, trim_threshold=10.0)),
    "pcg": (dict(P=8, L=100, pose_noise=0.05, lm_noise=0.3, px_noise=0.3, seed=6),
            dict(max_iterations=25, schur_solver="pcg", cg_iterations=128)),
}


@pytest.mark.parametrize("case", sorted(BACKEND_CASES))
def test_optimize_matches_the_jax_package(case):
    """Final cost within 1e-3 relative and ATE within 2e-3 m of the JAX run,
    and tests/test_backend.py's own assertions on the port's result."""
    kw, skw = BACKEND_CASES[case]
    cam, jp, gt_t, gt_lm = synthetic_ba(**kw)
    jo, ji = jba.optimize(jp, cam=cam, solver=jba.BASolverConfig(**skw))
    to, ti = ba.optimize(port_problem(jp), cam=port_cam(cam), solver=ba.BASolverConfig(**skw))
    assert ti["cost"] == pytest.approx(ji["cost"], rel=1e-3, abs=1e-4)
    ate_t = metrics.ate_rmse(to.poses_t.numpy(), gt_t, align=False)
    ate_j = jmetrics.ate_rmse(np.asarray(jo.poses_t), gt_t, align=False)
    assert abs(ate_t - ate_j) < 2e-3
    assert ti["trimmed"] == ji["trimmed"]
    h = ti["history"]
    assert h[-1] <= h[0]
    if case == "cost_monotone":
        assert ti["accepted"] >= 1
    elif case == "zero_noise":
        assert ti["cost"] < 1e-2
    elif case == "landmark_noise":
        assert np.median(np.linalg.norm(to.landmarks.numpy() - gt_lm, axis=-1)) < 0.02 and ti["cost"] < 0.05
    elif case == "pose_and_landmark_noise":
        ate_before = metrics.ate_rmse(np.asarray(jp.poses_t), gt_t, align=False)
        assert ate_t < 0.25 * ate_before and ate_t < 0.02
    elif case == "huber_outliers":
        assert ti["trimmed"] > 10 and ate_t < 0.05
