"""Segment BA on two problems, and the landmark-sharded dense solve on a
third, in either package, on the CPU: the figures the port's distributed
solvers are printed beside where the JAX package's own solver is the
yardstick (chip_smoke.py phase 11 (b), (c) and (d); ROADMAP C).

  benchmark  the BA benchmark's monocular problem (io/synthetic.make_problem,
             5 observations per landmark, clean), n_seg 8, sweeps 2, polish 3,
             25 LM iterations and 32 CG iterations: final cost and ATE beside
             the initial ATE;
  drifting   tests/test_segment_ba.py's beyond-the-dense-ceiling trajectory
             (synthetic_ba_problem, 4 observations per landmark, stereo,
             pose_walk 0.02, pose_noise 0.01, seed 7), n_seg 8, sweeps 2,
             polish 2, 8 LM iterations: final cost beside the initial and the
             ground truth's.
  sharded    chip_smoke.py phase 7 (a)'s problem (synthetic_ba_problem's
             defaults), the landmark-sharded dense solve over 2 shards (the
             JAX package's on a 2-device CPU mesh), 25 LM iterations: final
             cost and ATE.

    python torch_segment_cases.py benchmark 500 100000 jax
    python torch_segment_cases.py drifting 4096 100000 port
    python torch_segment_cases.py sharded 64 4096 jax

Imports the JAX package only for `jax` (the port's CPU parity tests import it
too); chip_smoke.py imports nothing of this file.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _gt_quats(P: int) -> np.ndarray:
    yaw = 0.005 * np.arange(P)
    return np.stack([np.cos(yaw / 2), np.zeros(P), np.sin(yaw / 2), np.zeros(P)], -1).astype(np.float32)


def run(case: str, P: int, L: int, package: str) -> dict:
    """One case's segment run on the CPU; returns its readings."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import ba
    from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem, synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    if case == "benchmark":
        problem, gt_t, _ = make_problem(P, L, 5, return_gt=True, clean=True, device="cpu")
        cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3))
        solver = dict(max_iterations=25, cg_iterations=32)
        segments = dict(n_seg=8, sweeps=2, polish_iterations=3)
        gt = None
    elif case == "sharded":
        cam, problem, gt_t, _ = synthetic_ba_problem(P=P, L=L, device="cpu")
        solver = dict(max_iterations=25, schur_solver="dense")
        gt = None
    elif case == "drifting":
        cam, problem, gt_t, gt_lm = synthetic_ba_problem(P=P, L=L, obs_per_lm=4, seed=7, stereo=True,
                                                         pose_noise=0.01, pose_walk=0.02, device="cpu")
        solver = dict(max_iterations=8)
        segments = dict(n_seg=8, sweeps=2, polish_iterations=2)
        gt = problem.replace(poses_t=torch.from_numpy(gt_t), poses_q=torch.from_numpy(_gt_quats(P)),
                             landmarks=torch.from_numpy(gt_lm))
    else:
        raise ValueError(f"unknown case {case!r}")
    t0 = time.perf_counter()
    if package == "port" and case == "sharded":
        from vision_slam_frontend_tpu_torch.parallel.mesh import LocalShards
        from vision_slam_frontend_tpu_torch.parallel.sharded_ba import optimize_sharded_dense

        opt, info = optimize_sharded_dense(problem, LocalShards(2, "cpu"), cam=cam, solver=ba.BASolverConfig(**solver))
        poses = opt.poses_t.numpy()
        gt_cost = None
    elif package == "port":
        opt, info = optimize_segments(problem, cam=cam, solver=ba.BASolverConfig(**solver), **segments)
        poses = opt.poses_t.numpy()
        gt_cost = None if gt is None else float(ba.compute_cost(cam, gt, 4.0, 30.0, 60.0, True))
    elif package == "jax":
        import os

        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from vision_slam_frontend_tpu.backend import ba as jba
        from vision_slam_frontend_tpu.backend.residuals import CameraParams as JaxCamera
        from vision_slam_frontend_tpu.parallel.segment_ba import optimize_segments as jax_segments
        from vision_slam_frontend_tpu.types.slam_types import BAProblem as JaxProblem

        def jax_problem(p):
            return JaxProblem(**{k: jnp.asarray(v) for k, v in p.to_numpy().items()})

        jcam = JaxCamera(**{f: jnp.asarray(getattr(cam, f).numpy()) for f in JaxCamera.__dataclass_fields__})
        if case == "sharded":
            from vision_slam_frontend_tpu.parallel import make_mesh
            from vision_slam_frontend_tpu.parallel.sharded_ba import optimize_sharded_dense

            opt, info = optimize_sharded_dense(jax_problem(problem), make_mesh(2), cam=jcam,
                                               solver=jba.BASolverConfig(**solver))
        else:
            opt, info = jax_segments(jax_problem(problem), cam=jcam, solver=jba.BASolverConfig(**solver), **segments)
        poses = np.asarray(opt.poses_t)
        w = tuple(jnp.float32(x) for x in (4.0, 30.0, 60.0))
        gt_cost = None if gt is None else float(jba.compute_cost(jcam, jax_problem(gt), *w, True))
    else:
        raise ValueError(f"unknown package {package!r}")
    return {"case": case, "package": package, "P": P, "L": L, "seconds": time.perf_counter() - t0,
            "initial_cost": float(info["history"][0]), "cost": float(info["cost"]), "history": info["history"],
            "initial_ate": ate_rmse(problem.poses_t.numpy(), gt_t), "ate": ate_rmse(poses, gt_t), "gt_cost": gt_cost}


if __name__ == "__main__":
    case, P, L, package = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    print(json.dumps(run(case, P, L, package)))
