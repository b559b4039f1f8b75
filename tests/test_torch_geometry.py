"""The port's SE(3), rotation, camera and math helpers (geometry/se3.py,
geometry/rotation.py, geometry/camera.py, utils/math.py) and
`ops/hamming.hamming_distance_matrix` against the JAX package's on the same
seeded inputs, and tests/test_geometry.py's and tests/test_math_utils.py's
property cases run on the port.

Tolerances: float32 results within 1e-6 of the largest magnitude (relative);
solve_quadratic's root counts and hamming_distance_matrix exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import vision_slam_frontend_tpu.geometry as jgeo  # noqa: E402
import vision_slam_frontend_tpu_torch.geometry as tgeo  # noqa: E402
from vision_slam_frontend_tpu.geometry.camera import Intrinsics as JIntrinsics  # noqa: E402
from vision_slam_frontend_tpu.ops.hamming import hamming_distance_matrix as j_hamming  # noqa: E402
from vision_slam_frontend_tpu.types.slam_types import SLAMNodeSolution as JSolution  # noqa: E402
from vision_slam_frontend_tpu.utils import math as jmu  # noqa: E402
from vision_slam_frontend_tpu_torch.geometry.camera import Intrinsics  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.hamming import hamming_distance_matrix  # noqa: E402
from vision_slam_frontend_tpu_torch.types import slam_types as ttypes  # noqa: E402
from vision_slam_frontend_tpu_torch.utils import math as mu  # noqa: E402

REL = 1e-6
RIG = dict(fx=527.873518, fy=527.276819, cx=482.823413, cy=298.033945,
           k1=-0.153137, k2=0.075666, p1=-0.000227, p2=-0.000320, k3=0.0)


def close(ours, theirs, rel=REL):
    a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    b = np.asarray(theirs)
    assert a.shape == b.shape, (a.shape, b.shape)
    finite = np.isfinite(b)
    assert np.array_equal(a[~finite], b[~finite])  # the same infinities where the z-guard overflows
    a, b = a[finite], b[finite]
    scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
    assert float(np.abs(a.astype(np.float64) - b).max()) <= rel * scale


def quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


T = torch.from_numpy


def test_exports_are_the_jax_packages():
    assert tgeo.__all__ == jgeo.__all__
    for name in tgeo.__all__:
        assert callable(getattr(tgeo, name)), name


def test_rotation_functions_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    q = quats(rng, 64)
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:4] *= 1e-6  # the small-angle branch
    close(tgeo.quat_identity(), jgeo.quat_identity())
    close(tgeo.axis_angle_to_matrix(T(aa)), jgeo.axis_angle_to_matrix(jnp.asarray(aa)))
    m = np.array(jgeo.quat_to_matrix(jnp.asarray(q)))
    close(tgeo.matrix_to_axis_angle(T(m)), jgeo.matrix_to_axis_angle(jnp.asarray(m)))
    q2 = quats(rng, 64)
    close(tgeo.quat_angular_distance(T(q), T(q2)), jgeo.quat_angular_distance(jnp.asarray(q), jnp.asarray(q2)))
    assert tgeo.quat_identity(torch.float64).dtype == torch.float64


def _poses(mod, rng, n):
    t = rng.normal(size=(n, 3)).astype(np.float32)
    q = quats(rng, n)
    if mod is tgeo:
        return tgeo.Pose3(t=T(t), q=T(q))
    return jgeo.Pose3(t=jnp.asarray(t), q=jnp.asarray(q))


def test_pose3_functions_equal_the_jax_packages():
    a_t, b_t = _poses(tgeo, np.random.default_rng(1), 16), _poses(tgeo, np.random.default_rng(2), 16)
    a_j, b_j = _poses(jgeo, np.random.default_rng(1), 16), _poses(jgeo, np.random.default_rng(2), 16)
    x = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    for ours, theirs in ((tgeo.pose_compose(a_t, b_t), jgeo.pose_compose(a_j, b_j)),
                         (tgeo.pose_inverse(a_t), jgeo.pose_inverse(a_j)),
                         (tgeo.pose_relative(a_t, b_t), jgeo.pose_relative(a_j, b_j)),
                         (tgeo.pose_identity(), jgeo.pose_identity())):
        close(ours.t, theirs.t)
        close(ours.q, theirs.q)
    close(a_t.as_matrix(), a_j.as_matrix())
    close(tgeo.pose_transform_points(a_t, T(x)), jgeo.pose_transform_points(a_j, jnp.asarray(x)))


def test_camera_functions_equal_the_jax_packages():
    rng = np.random.default_rng(4)
    ours, theirs = Intrinsics.create(**RIG), JIntrinsics.create(**RIG)
    px = rng.uniform([100, 100], [860, 500], size=(200, 2)).astype(np.float32)
    close(tgeo.distort_points(ours, T(px)), jgeo.distort_points(theirs, jnp.asarray(px)))
    pts = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50), rng.uniform(2, 10, 50)], -1).astype(np.float32)
    pts[:3, 2] = [0.0, 5e-10, -5e-10]  # the z-guard and its sign
    for distort in (False, True):
        close(tgeo.project_points(ours, T(pts), distort=distort),
              jgeo.project_points(theirs, jnp.asarray(pts), distort=distort))


# --- tests/test_geometry.py's cases, on the port.

def test_quaternion_cases():
    rng = np.random.default_rng(0)
    v = torch.tensor([1.0, 2.0, 3.0])
    np.testing.assert_allclose(tgeo.quat_rotate(tgeo.quat_identity(), v), v, atol=1e-6)
    a, b = T(quats(rng, 32)), T(quats(rng, 32))
    np.testing.assert_allclose(tgeo.quat_to_matrix(tgeo.quat_multiply(a, b)),
                               tgeo.quat_to_matrix(a) @ tgeo.quat_to_matrix(b), atol=1e-5)
    q = quats(np.random.default_rng(3), 64)
    q = q * np.sign(q[..., :1])
    np.testing.assert_allclose(tgeo.matrix_to_quat(tgeo.quat_to_matrix(T(q))), q, atol=1e-5)
    for angle in [0.1, 0.5, 1.5]:
        q1 = tgeo.axis_angle_to_quat(torch.tensor([0.0, 0.0, angle]))
        np.testing.assert_allclose(float(tgeo.quat_angular_distance(tgeo.quat_identity(), q1)), angle, atol=1e-5)
    aa = torch.tensor([[0.01, -0.02, 0.015]])
    np.testing.assert_allclose(tgeo.matrix_to_axis_angle(tgeo.axis_angle_to_matrix(aa)), aa, atol=1e-6)


def test_pose3_cases():
    rng = np.random.default_rng(5)
    p = tgeo.Pose3(t=T(rng.normal(size=3).astype(np.float32)), q=T(quats(rng, 1)[0]))
    ident = tgeo.pose_compose(p, tgeo.pose_inverse(p))
    np.testing.assert_allclose(ident.t, np.zeros(3), atol=1e-5)
    np.testing.assert_allclose(abs(float(ident.q[0])), 1.0, atol=1e-5)
    rng = np.random.default_rng(6)
    qa, qb = quats(rng, 2)
    a = tgeo.Pose3(t=T(rng.normal(size=3).astype(np.float32)), q=T(qa))
    b = tgeo.Pose3(t=T(rng.normal(size=3).astype(np.float32)), q=T(qb))
    b2 = tgeo.pose_compose(a, tgeo.pose_relative(a, b))
    np.testing.assert_allclose(b2.t, b.t, atol=1e-5)
    assert float(tgeo.quat_angular_distance(b2.q, b.q)) < 1e-4
    x = T(np.random.default_rng(7).normal(size=(10, 3)).astype(np.float32))
    m = a.as_matrix().numpy()
    np.testing.assert_allclose(tgeo.pose_transform_points(a, x), (m[:3, :3] @ x.numpy().T).T + m[:3, 3], atol=1e-5)
    assert dataclasses.is_dataclass(a)


def test_camera_cases():
    intr = Intrinsics.create(**RIG)
    px = np.random.default_rng(8).uniform([100, 100], [860, 500], size=(200, 2)).astype(np.float32)
    np.testing.assert_allclose(tgeo.undistort_points(intr, tgeo.distort_points(intr, T(px))), px, atol=1e-2)
    rng = np.random.default_rng(10)
    pts = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50), rng.uniform(2, 10, 50)], -1).astype(np.float32)
    xn = (tgeo.project_points(intr, T(pts)).numpy() - [intr.cx, intr.cy]) / [intr.fx, intr.fy]
    np.testing.assert_allclose(xn * pts[:, 2:3], pts[:, :2], atol=1e-3)


# --- utils/math.py against the JAX package's, and tests/test_math_utils.py's cases.

MATH_CASES = [
    ("clamp", (np.float32([-1.0, 0.5, 2.0]), 0.0, 1.0)),
    ("deg_to_rad", (np.float32([180.0, -45.0]),)),
    ("rad_to_deg", (np.float32([np.pi / 2, 1.0]),)),
    ("angle_mod", (np.float32([3 * np.pi, -7.0, 0.25, 100.0]),)),
    ("angle_diff", (np.float32([0.1, 3.0]), np.float32([2 * np.pi - 0.1, -3.0]))),
    ("angle_dist", (np.float32([0.1, 3.0]), np.float32([2 * np.pi - 0.1, -3.0]))),
    ("sq", (np.float32([1.5, -2.0]),)),
    ("cube", (np.float32([1.5, -2.0]),)),
    ("ramp", (np.float32([5.0, -5.0, 15.0]), 0.0, 10.0, 100.0, 200.0)),
    ("solve_cubic", (np.float32([1.0, 2.0, 1.0]), np.float32([-6.0, 0.0, 0.5]), np.float32([11.0, 0.0, -3.0]),
                     np.float32([-6.0, -16.0, 2.0]))),
]


@pytest.mark.parametrize("name, args", MATH_CASES, ids=[c[0] for c in MATH_CASES])
def test_math_equals_the_jax_packages(name, args):
    ours = getattr(mu, name)(*[T(a) if isinstance(a, np.ndarray) else a for a in args])
    theirs = getattr(jmu, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    close(ours, theirs)


def test_solve_quadratic_equals_the_jax_packages():
    rng = np.random.default_rng(9)
    a = rng.normal(size=64).astype(np.float32)
    a[:8] = 0.0  # linear
    b = rng.normal(size=64).astype(np.float32)
    b[:2] = 0.0  # no equation
    c = rng.normal(size=64).astype(np.float32)
    a[8:10], b[8:10], c[8:10] = 1.0, 2.0, 1.0  # a double root
    n, r0, r1 = mu.solve_quadratic(T(a), T(b), T(c))
    jn, j0, j1 = jmu.solve_quadratic(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert {0, 1, 2} <= set(n.tolist())
    close(r0, j0)
    close(r1, j1)
    assert not (torch.isnan(r0).any() or torch.isnan(r1).any())


def test_math_cases():
    np.testing.assert_allclose(mu.clamp(torch.tensor([-1.0, 0.5, 2.0]), 0.0, 1.0), [0, 0.5, 1])
    np.testing.assert_allclose(float(mu.ramp(5.0, 0.0, 10.0, 100.0, 200.0)), 150.0)
    assert abs(abs(float(mu.angle_mod(3 * np.pi))) - np.pi) < 1e-6
    np.testing.assert_allclose(float(mu.angle_dist(0.1, 2 * np.pi - 0.1)), 0.2, atol=1e-6)
    n, r0, r1 = mu.solve_quadratic(1.0, -3.0, 2.0)
    assert int(n) == 2
    np.testing.assert_allclose([float(r0), float(r1)], [1.0, 2.0], atol=1e-5)
    assert int(mu.solve_quadratic(1.0, 0.0, 1.0)[0]) == 0
    n, r0, _ = mu.solve_quadratic(0.0, 2.0, -4.0)
    assert int(n) == 1 and abs(float(r0) - 2.0) < 1e-5
    r = float(mu.solve_cubic(1.0, -6.0, 11.0, -6.0))
    assert min(abs(r - 1), abs(r - 2), abs(r - 3)) < 1e-4
    np.testing.assert_allclose(float(mu.solve_cubic(2.0, 0.0, 0.0, -16.0)), 2.0, atol=1e-4)


@pytest.mark.parametrize("shape_q", [(64,), (3, 40)])
def test_hamming_distance_matrix_equals_the_jax_packages(shape_q):
    rng = np.random.default_rng(len(shape_q))
    bq = rng.integers(0, 2, size=shape_q + (256,)).astype(np.float32)
    bt = rng.integers(0, 2, size=(48, 256)).astype(np.float32)
    ours = hamming_distance_matrix(T(bq), T(bt))
    theirs = np.asarray(j_hamming(jnp.asarray(bq), jnp.asarray(bt)))
    assert ours.dtype == torch.float32 and np.array_equal(ours.numpy(), theirs)
    assert np.array_equal(theirs, (bq[..., :, None, :] != bt[None, :, :]).sum(-1))


def test_slam_node_solution_equals_the_jax_packages():
    rng = np.random.default_rng(11)
    q = quats(rng, 1)[0]
    feats = [ttypes.VisionFeature(i, np.zeros(2, np.float32), np.ones(3, np.float32)) for i in range(5)]
    node = ttypes.SLAMNode(3, 1.5, ttypes.RobotPose(rng.normal(size=3).astype(np.float32), q), feats)
    ours, theirs = ttypes.SLAMNodeSolution.from_node(node), JSolution.from_node(node)
    assert (ours.node_idx, ours.timestamp) == (theirs.node_idx, theirs.timestamp)
    assert ours.pose.dtype == theirs.pose.dtype == np.float64
    close(ours.pose, theirs.pose)
    assert np.array_equal(ours.inverse_depths, theirs.inverse_depths)
    assert np.array_equal(ours.point_in_map, theirs.point_in_map)
