"""The port stands alone: with `jax`, `jaxlib` and the JAX package made
unimportable, every module of `vision_slam_frontend_tpu_torch` and
`chip_smoke.py` still imports, and a config round trip and an EuRoC
calibration run; and the port's own copies of the synthetic world, the BA
problem generators and the host quaternion helpers give the JAX package's
arrays exactly.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import vision_slam_frontend_tpu_torch  # noqa: E402
from vision_slam_frontend_tpu.io import synthetic as jsyn  # noqa: E402
from vision_slam_frontend_tpu.utils import np_geom as jgeom  # noqa: E402
from vision_slam_frontend_tpu_torch.io import synthetic as tsyn  # noqa: E402
from vision_slam_frontend_tpu_torch.utils import np_geom as tgeom  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, runpy, sys

BLOCKED = ("jax", "jaxlib", "vision_slam_frontend_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
for name in sys.argv[1:]:
    if name.startswith("exec:"):
        exec(name[5:])
    elif name.endswith(".py"):
        runpy.run_path(name, run_name="not_main")
    else:
        importlib.import_module(name)
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
'''


def _port_modules():
    names = [vision_slam_frontend_tpu_torch.__name__]
    for info in pkgutil.walk_packages(vision_slam_frontend_tpu_torch.__path__, prefix="vision_slam_frontend_tpu_torch."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_without_jax():
    modules = _port_modules() + ["torch_edge_cases"]  # chip_smoke's edge-case inputs
    assert {"vision_slam_frontend_tpu_torch.ops.akaze", "vision_slam_frontend_tpu_torch.ops.kernel_variants",
            "vision_slam_frontend_tpu_torch.cli.slam_frontend", "vision_slam_frontend_tpu_torch.cli.slam_backend",
            "vision_slam_frontend_tpu_torch.cli.evaluate", "vision_slam_frontend_tpu_torch.backend.ba",
            "vision_slam_frontend_tpu_torch.backend.residuals", "vision_slam_frontend_tpu_torch.backend.tracks",
            "vision_slam_frontend_tpu_torch.backend.metrics", "vision_slam_frontend_tpu_torch.utils.checks",
            "vision_slam_frontend_tpu_torch.utils.device", "vision_slam_frontend_tpu_torch.backend.local_ba",
            "vision_slam_frontend_tpu_torch.backend.merge", "vision_slam_frontend_tpu_torch.cli.slam_merge",
            "vision_slam_frontend_tpu_torch.backend.dense_plateau", "vision_slam_frontend_tpu_torch.ops.sift",
            "vision_slam_frontend_tpu_torch.frontend.frontend", "vision_slam_frontend_tpu_torch.io.rosbag",
            "vision_slam_frontend_tpu_torch.io.ros_msgs", "vision_slam_frontend_tpu_torch.io.image",
            "vision_slam_frontend_tpu_torch.io.native_loader", "vision_slam_frontend_tpu_torch.io.degrade",
            "vision_slam_frontend_tpu_torch.io.kitti", "vision_slam_frontend_tpu_torch.io.euroc",
            "vision_slam_frontend_tpu_torch.cli.bag_extract", "vision_slam_frontend_tpu_torch.viz.ply",
            "vision_slam_frontend_tpu_torch.viz.html", "vision_slam_frontend_tpu_torch.utils.cuda_graph",
            "vision_slam_frontend_tpu_torch.parallel.mesh", "vision_slam_frontend_tpu_torch.parallel.segment_ba",
            "vision_slam_frontend_tpu_torch.parallel.sharded_ba", "vision_slam_frontend_tpu_torch.parallel.comm_report",
            "vision_slam_frontend_tpu_torch.parallel.multihost_smoke", "vision_slam_frontend_tpu_torch.viz.live",
            "vision_slam_frontend_tpu_torch.viz.debug_images", "vision_slam_frontend_tpu_torch.utils.profiling",
            "vision_slam_frontend_tpu_torch.cli.profile_stages", "vision_slam_frontend_tpu_torch.geometry.se3",
            "vision_slam_frontend_tpu_torch.utils.math"} <= set(modules)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, *modules, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(modules) + 1}" in proc.stdout


def test_config_and_euroc_calibration_run_without_jax(tmp_path):
    """With jax and the JAX package blocked: FrontendConfig.save then load
    gives the same config, and euroc_calib reads a written sensor.yaml."""
    from tests.test_torch_io import _euroc_sensor_dirs

    root = tmp_path / "euroc"
    _euroc_sensor_dirs(str(root), 3)
    code = (
        "from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig\n"
        "from vision_slam_frontend_tpu_torch.io.euroc import euroc_calib\n"
        f"calib = euroc_calib({str(root)!r})\n"
        "c = FrontendConfig(calib=calib, descriptor_family='sift', max_features=300, validate=True)\n"
        f"c.save({str(tmp_path / 'c.yaml')!r})\n"
        f"d = FrontendConfig.load({str(tmp_path / 'c.yaml')!r})\n"
        "assert d.calib == calib and (d.descriptor_family, d.max_features, d.validate) == ('sift', 300, True)\n"
        "assert (d.fundamental == c.fundamental).all()\n"
    )
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, "exec:" + code],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported 1" in proc.stdout


def test_blocker_does_block():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, "vision_slam_frontend_tpu.io.synthetic"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and "blocked import of vision_slam_frontend_tpu" in proc.stderr


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_world_equals_the_jax_packages(seed):
    kw = dict(num_frames=3, seed=seed, odom_drift=0.01, roll_rate=0.002)
    rig = dict(width=320, height=240, cx=160.0, cy=120.0)
    ours = list(tsyn.generate_sequence(rig=tsyn.SyntheticRig(**rig), **kw))
    theirs = list(jsyn.generate_sequence(rig=jsyn.SyntheticRig(**rig), **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        for field in ("left", "right", "odom_translation", "odom_rotation", "cam_to_world_R", "cam_pos"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert a.timestamp == b.timestamp
    assert tsyn.SyntheticRig(**rig).calib() == jsyn.SyntheticRig(**rig).calib()
    np.testing.assert_array_equal(tsyn.make_texture(seed, size=128), jsyn.make_texture(seed, size=128))


@pytest.mark.parametrize("seed", [0, 5])
def test_np_geom_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4))
    v = rng.normal(size=3)
    aa = rng.normal(size=3)
    a, b = tgeom.quat_normalize(q[0]), tgeom.quat_normalize(q[1])
    np.testing.assert_array_equal(a, jgeom.quat_normalize(q[0]))
    for name, args in (("quat_multiply", (a, b)), ("quat_inverse", (a,)), ("quat_rotate", (a, v)),
                       ("quat_angular_distance", (a, b)), ("axis_angle_to_quat", (aa,)),
                       ("axis_angle_to_matrix", (aa,)), ("quat_multiply_batch", (q, q[::-1])),
                       ("quat_to_axis_angle", (a,))):
        np.testing.assert_array_equal(getattr(tgeom, name)(*args), getattr(jgeom, name)(*args), err_msg=name)


def _jax_arrays(problem) -> dict:
    return {f: np.asarray(getattr(problem, f)) for f in problem.__dataclass_fields__ if getattr(problem, f) is not None}


def _assert_same_arrays(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
def test_ba_problem_generators_equal_the_jax_packages(seed):
    """synthetic_ba_problem (mono and stereo, with and without gather tables)
    and the copy of bench_ba.make_problem (plain and clean, with its ground
    truth): every array equal, index arrays in the JAX package's int32."""
    import bench_ba

    for kw in (dict(stereo=False), dict(stereo=True, pose_walk=0.01, gather_tables=False)):
        jcam, jp, jt, jl = jsyn.synthetic_ba_problem(P=24, L=300, seed=seed, **kw)
        cam, p, t, lm = tsyn.synthetic_ba_problem(P=24, L=300, seed=seed, device="cpu", **kw)
        _assert_same_arrays(p.to_numpy(), _jax_arrays(jp))
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(lm, jl)
        for f in jcam.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)), err_msg=f)
    for clean in (False, True):
        jp, jt, jl = bench_ba.make_problem(40, 600, 4, seed=seed, return_gt=True, clean=clean)
        p, t, lm = tsyn.make_problem(40, 600, 4, seed=seed, return_gt=True, clean=clean, device="cpu")
        _assert_same_arrays(p.to_numpy(), _jax_arrays(jp))
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(lm, jl)
