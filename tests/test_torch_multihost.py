"""Two real processes of the port's multi-process smoke
(vision_slam_frontend_tpu_torch/parallel/multihost_smoke.py) over gloo on the
CPU: each joins one process group, runs the observation-sharded solve with
its all-reduces crossing the process boundary, and prints MULTIHOST_OK; the
final poses equal the single-process solve of the same problem within the
PCG tolerance. The counterpart of tests/test_multihost.py.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_ba():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "vision_slam_frontend_tpu_torch.parallel.multihost_smoke",
             "--coordinator", f"localhost:{port}", "--num_processes", "2", "--process_id", str(pid),
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # The same problem and solve in one process, without shards.
    cam, problem, _, _ = synthetic_ba_problem(P=16, L=1024, obs_per_lm=4, seed=0, stereo=True, pose_noise=0.03,
                                              device="cpu")
    single, info = ba.optimize(
        problem.replace(pose_obs=None, pose_obs_mask=None, lm_obs=None, lm_obs_mask=None), cam=cam,
        solver=ba.BASolverConfig(max_iterations=2, cg_iterations=8, trim_threshold=0.0),
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        ok_lines = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST_OK ")]
        assert ok_lines, f"process {pid} printed no MULTIHOST_OK:\n{out[-3000:]}"
        rec = json.loads(ok_lines[0][len("MULTIHOST_OK "):])
        assert rec["world_size"] == 2 and rec["num_processes"] == 2 and rec["backend"] == "gloo"
        assert rec["cost_final"] < rec["cost_initial"]
        assert rec["cost_final"] == pytest.approx(info["cost"], rel=3e-4)
        np.testing.assert_allclose(np.asarray(rec["poses_t"]), single.poses_t.numpy(), atol=2e-2)
