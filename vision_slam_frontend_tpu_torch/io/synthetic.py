"""Synthetic inputs: the port's self-contained stereo world and BA problems.

A copy of the JAX package's io/synthetic.py, so the port runs where the JAX
package is not installed: a deterministic textured tilted ground plane
rendered through the exact pinhole model, with ground-truth trajectory and
depth; and two bundle-adjustment worlds, `synthetic_ba_problem` and
`make_problem` (the copy of bench_ba.make_problem, the benchmark's shape).
The same seed gives the same frames and arrays, bit for bit, as the JAX
package's (tests/test_torch_isolation.py).

Everything is vectorized numpy on the host; the BA problems' tensors go to
the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from vision_slam_frontend_tpu_torch.utils import np_geom


def make_texture(seed: int = 0, size: int = 1024, noise: float = 2.0) -> np.ndarray:
    """High-contrast random-rectangle texture with micro-texture noise
    (corner-rich). `noise` is the per-texel sigma: real surfaces (asphalt,
    gravel, grass) carry several-intensity-unit micro-texture; the 2.0
    default keeps historical fixtures, the golden-loop fixture uses a
    realistic 6.0 so descriptor families aren't graded on sub-quantization
    signal no 8-bit camera can deliver."""
    rng = np.random.default_rng(seed)
    tex = np.full((size, size), 120.0, np.float32)
    for _ in range(size):
        y, x = rng.integers(0, size - 32, 2)
        h, w = rng.integers(6, 32, 2)
        tex[y : y + h, x : x + w] = rng.uniform(10, 245)
    tex += rng.normal(0, noise, tex.shape).astype(np.float32)
    return np.clip(tex, 0, 255)


@dataclasses.dataclass
class SyntheticRig:
    """A simple stereo rig: identical pinhole cameras, pure-x baseline, no
    distortion. `calib()` returns a FrontendConfig-compatible calib dict."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    baseline: float = 0.12
    width: int = 640
    height: int = 480

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )

    def calib(self) -> dict:
        zero_dist = dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
        intr = dict(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, **zero_dist)
        return {
            "intrinsics_left": dict(intr),
            "intrinsics_right": dict(intr),
            # x_right = x_left + [-baseline, 0, 0]
            "right_extrinsic": [
                [1.0, 0.0, 0.0, -self.baseline],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 0.0],
            ],
            "left_cam_to_robot_translation": [0.0, 0.0, 0.0],
            "left_cam_to_robot_rotation": [
                [1.0, 0.0, 0.0],
                [0.0, 1.0, 0.0],
                [0.0, 0.0, 1.0],
            ],
        }


@dataclasses.dataclass
class PlaneScene:
    """A textured plane: point p0, unit normal n, in-plane axes e1/e2."""

    texture: np.ndarray
    p0: np.ndarray  # (3,)
    n: np.ndarray  # (3,) unit
    e1: np.ndarray  # (3,) unit, in-plane
    e2: np.ndarray  # (3,) unit, in-plane
    scale: float  # metres per full texture extent

    @classmethod
    def ground(cls, texture: np.ndarray, height: float = 1.4, tilt: float = 0.10, scale: float = 40.0):
        """Camera-below ground plane (y-down camera convention), slightly
        tilted so depth varies and the scene is non-degenerate."""
        n = np.array([0.0, -1.0, tilt])
        n = n / np.linalg.norm(n)
        e1 = np.array([1.0, 0.0, 0.0])
        e1 = e1 - n * (e1 @ n)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        return cls(texture=texture, p0=np.array([0.0, height, 0.0]), n=n, e1=e1, e2=e2, scale=scale)

    def render(self, K: np.ndarray, cam_to_world_R: np.ndarray, cam_pos: np.ndarray, H: int, W: int) -> np.ndarray:
        """Render the plane through an ideal pinhole camera: per-pixel
        ray/plane intersection + bilinear texture sampling, fully vectorized."""
        Kinv = np.linalg.inv(K)
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        rays_cam = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (H, W, 3)
        rays_w = rays_cam @ cam_to_world_R.T
        denom = rays_w @ self.n
        tnum = (self.p0 - cam_pos) @ self.n
        with np.errstate(divide="ignore", invalid="ignore"):
            tstar = tnum / denom
        hit = (tstar > 0.05) & np.isfinite(tstar)
        X = cam_pos + rays_w * tstar[..., None]
        rel = X - self.p0
        tex = self.texture
        th, tw = tex.shape
        u_t = (rel @ self.e1) / self.scale * tw + tw * 0.5
        v_t = (rel @ self.e2) / self.scale * th + th * 0.5
        u_t = np.clip(u_t, 0, tw - 1.001)
        v_t = np.clip(v_t, 0, th - 1.001)
        x0 = u_t.astype(np.int32)
        y0 = v_t.astype(np.int32)
        fx = u_t - x0
        fy = v_t - y0
        img = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        return np.where(hit, img, 0.0).astype(np.float32)

    def depth(self, K: np.ndarray, cam_to_world_R: np.ndarray, cam_pos: np.ndarray, pixels: np.ndarray) -> np.ndarray:
        """Ground-truth z-depth (camera frame) of plane points behind pixels."""
        Kinv = np.linalg.inv(K)
        ph = np.concatenate([pixels, np.ones_like(pixels[..., :1])], axis=-1)
        rays_cam = ph @ Kinv.T
        rays_w = rays_cam @ cam_to_world_R.T
        tstar = ((self.p0 - cam_pos) @ self.n) / (rays_w @ self.n)
        return tstar * rays_cam[..., 2]


@dataclasses.dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    odom_translation: np.ndarray  # (3,)
    odom_rotation: np.ndarray  # (4,) [w,x,y,z]
    cam_to_world_R: np.ndarray
    cam_pos: np.ndarray


def generate_sequence(
    num_frames: int = 30,
    step: float = 0.25,
    yaw_rate: float = 0.01,
    rig: SyntheticRig | None = None,
    seed: int = 0,
    odom_drift: float = 0.0,
    texture_noise: float = 2.0,
    roll_rate: float = 0.0,
    pitch_rate: float = 0.0,
) -> Iterator[StereoFrame]:
    """A forward-moving, slowly-yawing stereo trajectory over the plane.

    Motion per frame (`step` metres) exceeds the reference's 0.2 m keyframe
    gate, so each frame becomes a keyframe. Odometry is the camera pose
    (robot frame == left camera frame in the synthetic rig); with
    `odom_drift > 0` the reported odometry accumulates a random-walk
    translation error of that magnitude (metres/frame) while the rendered
    images stay at ground truth — the realistic drifting-odometry scenario
    BA is supposed to correct (the reference README itself warns its
    odometry-derived trajectory drifts, reference: README.md:44).
    """
    rig = rig or SyntheticRig()
    tex = make_texture(seed, noise=texture_noise)
    scene = PlaneScene.ground(tex)
    K = rig.K()
    rng = np.random.default_rng(seed + 12345)
    pos = np.zeros(3)
    yaw = 0.0
    roll = 0.0
    pitch = 0.0
    drift = np.zeros(3)
    for i in range(num_frames):
        cy, sy = np.cos(yaw), np.sin(yaw)
        # Yaw about the camera's -y (up) axis.
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])  # yaw about +y
        if roll_rate != 0.0 or pitch_rate != 0.0:
            # Full 3-DoF attitude: R = R_y(yaw) R_x(pitch) R_z(roll), with
            # the quaternion composed in the same order. Roll spins the
            # image in-plane (camera +z); pitch tilts the horizon (camera
            # +x; NEGATIVE pitch looks down in the y-down convention).
            cp, sp = np.cos(pitch), np.sin(pitch)
            cr, sr = np.cos(roll), np.sin(roll)
            Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float64)
            Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float64)
            R = R @ Rx @ Rz
            qx = np.array([np.cos(pitch / 2), np.sin(pitch / 2), 0.0, 0.0])
            qz = np.array([np.cos(roll / 2), 0.0, 0.0, np.sin(roll / 2)])
            q = np_geom.quat_multiply(np_geom.quat_multiply(q, qx), qz)
        left = scene.render(K, R, pos, rig.height, rig.width)
        right_pos = pos + R @ np.array([rig.baseline, 0.0, 0.0])
        right = scene.render(K, R, right_pos, rig.height, rig.width)
        if odom_drift > 0 and i > 0:
            drift = drift + rng.normal(0.0, odom_drift, 3)
        yield StereoFrame(
            timestamp=float(i) * 0.5,
            left=left,
            right=right,
            odom_translation=pos + drift,
            odom_rotation=np_geom.quat_normalize(q),
            cam_to_world_R=R,
            cam_pos=pos.copy(),
        )
        pos = pos + R @ np.array([0.0, 0.0, step])
        yaw += yaw_rate
        roll += roll_rate
        pitch += pitch_rate


def _odometry_chain(P: int, odom_t, odom_q) -> dict:
    return dict(
        odom_i=np.arange(P - 1), odom_j=np.arange(1, P),
        odom_t=np.asarray(odom_t, np.float32), odom_q=np.asarray(odom_q, np.float32),
        odom_mask=np.ones(P - 1, bool),
    )


def synthetic_ba_problem(
    P: int = 256,
    L: int = 4096,
    obs_per_lm: int = 4,
    pose_noise: float = 0.02,
    pose_walk: float = 0.0,
    lm_noise: float = 0.1,
    px_noise: float = 0.3,
    step: float = 0.25,
    yaw_rate: float = 0.005,
    seed: int = 0,
    stereo: bool = False,
    gather_tables: bool = True,
    device="cuda",
):
    """Vectorized large-scale synthetic BA world.

    A long yaw-turning trajectory; landmark j is anchored in front of pose
    a_j = floor(j*P/L) and observed by the next `obs_per_lm` consecutive
    poses, the locality of a real SLAM run. Scales to P in the thousands and
    L in the 100k range in milliseconds.

    Returns (cam: CameraParams, problem: BAProblem, gt_t (P,3), gt_lm (L,3)),
    the camera and the problem's tensors on `device` (default cuda).
    """
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.backend.tracks import build_gather_tables
    from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0

    # --- GT trajectory: planar, yaw about +y (camera convention y-down).
    yaw = yaw_rate * np.arange(P)
    cyw, syw = np.cos(yaw), np.sin(yaw)
    fwd = np.stack([syw, np.zeros(P), cyw], -1)  # R(yaw) @ [0,0,1]
    gt_t = np.concatenate([np.zeros((1, 3)), np.cumsum(step * fwd[:-1], 0)])

    def rot(yaws):  # (K,) -> (K, 3, 3) world-from-camera
        c, s = np.cos(yaws), np.sin(yaws)
        z = np.zeros_like(c)
        o = np.ones_like(c)
        return np.stack(
            [np.stack([c, z, s], -1), np.stack([z, o, z], -1), np.stack([-s, z, c], -1)], -2,
        )

    # --- Landmarks anchored ahead of their anchor pose.
    anchor = (np.arange(L) * P) // L
    local = np.stack(
        [rng.uniform(-3, 3, L), rng.uniform(-1.5, 1.5, L), rng.uniform(4, 14, L)], -1,
    )
    gt_lm = gt_t[anchor] + np.einsum("lij,lj->li", rot(yaw[anchor]), local)

    # --- Observations: poses anchor..anchor+obs_per_lm-1 (clipped to P).
    obs_pose = np.minimum(anchor[:, None] + np.arange(obs_per_lm)[None, :], P - 1)
    obs_lm = np.broadcast_to(np.arange(L)[:, None], obs_pose.shape)
    rel = gt_lm[obs_lm] - gt_t[obs_pose]  # (L, O, 3)
    Rw = rot(yaw)  # (P, 3, 3); camera frame: p_cam = R^T rel
    p_cam = np.einsum("loji,loj->loi", Rw[obs_pose], rel)
    u = fx * p_cam[..., 0] / np.maximum(p_cam[..., 2], 1e-6) + cx
    v = fy * p_cam[..., 1] / np.maximum(p_cam[..., 2], 1e-6) + cy
    valid = (p_cam[..., 2] > 0.5) & (u >= 0) & (u < 640) & (v >= 0) & (v < 480)
    # Dedup repeated (pose, lm) pairs from the end-of-trajectory clip.
    dup = np.zeros_like(valid)
    dup[:, 1:] = obs_pose[:, 1:] == obs_pose[:, :-1]
    valid &= ~dup
    px = np.stack([u, v], -1) + rng.normal(0, px_noise, (*u.shape, 2))

    keep = valid.reshape(-1)
    obs_pose = obs_pose.reshape(-1)[keep].astype(np.int32)
    obs_lm = obs_lm.reshape(-1)[keep].astype(np.int32)
    px = px.reshape(-1, 2)[keep].astype(np.float32)
    N = obs_pose.shape[0]

    # --- Noisy initialization (gauge: pose 0 exact): i.i.d. jitter and an
    # accumulating random-walk drift (odometry integration error).
    init_t = gt_t + rng.normal(0, pose_noise, gt_t.shape)
    if pose_walk > 0:
        init_t += np.cumsum(rng.normal(0, pose_walk, gt_t.shape), axis=0)
    init_t[0] = gt_t[0]
    dyaw = rng.normal(0, pose_noise * 0.3, P)
    if pose_walk > 0:
        dyaw += np.cumsum(rng.normal(0, pose_walk * 0.1, P))
    dyaw[0] = 0.0
    init_q = np.stack(
        [np.cos((yaw + dyaw) / 2), np.zeros(P), np.sin((yaw + dyaw) / 2), np.zeros(P)], -1,
    )
    init_lm = gt_lm + rng.normal(0, lm_noise, gt_lm.shape)

    # --- Odometry factors from GT relative poses (yaw-only: closed form).
    dy = yaw[1:] - yaw[:-1]
    odom_t = np.einsum("qji,qj->qi", Rw[:-1], gt_t[1:] - gt_t[:-1])
    odom_q = np.stack([np.cos(dy / 2), np.zeros(P - 1), np.sin(dy / 2), np.zeros(P - 1)], -1)

    arrays = dict(
        poses_t=init_t, poses_q=init_q, pose_mask=np.ones(P, bool),
        landmarks=init_lm, landmark_mask=np.ones(L, bool),
        obs_pose=obs_pose, obs_landmark=obs_lm, obs_pixel=px, obs_mask=np.ones(N, bool),
        **_odometry_chain(P, odom_t, odom_q),
    )
    if gather_tables:
        po, pom, lo, lom = build_gather_tables(obs_pose, obs_lm, np.ones(N, bool), P, L)
        arrays.update(pose_obs=po, pose_obs_mask=pom, lm_obs=lo, lm_obs_mask=lom)
    cam_kwargs = {}
    if stereo:
        baseline = 0.12
        # Right camera at +baseline along camera x: x_r = x_l + [-b, 0, 0].
        u_r = u - fx * baseline / np.maximum(p_cam[..., 2], 1e-6)
        px_r = np.stack([u_r, v], -1) + rng.normal(0, px_noise, (*u.shape, 2))
        arrays.update(obs_pixel_right=px_r.reshape(-1, 2)[keep], obs_right_mask=np.ones(N, bool))
        cam_kwargs = dict(R_rl=np.eye(3), t_rl=[-baseline, 0.0, 0.0])

    cam = CameraParams(fx=fx, fy=fy, cx=cx, cy=cy, R_cr=np.eye(3), t_cr=np.zeros(3), **cam_kwargs)
    problem = BAProblem.from_numpy(arrays, device=device)
    return cam.to(device), problem, gt_t.astype(np.float32), gt_lm.astype(np.float32)


def make_problem(P, L, obs_per_lm, seed=0, return_gt=False, clean=False, device="cuda"):
    """The BA benchmark's problem (the port's copy of bench_ba.make_problem).

    A forward trajectory with landmarks scattered ahead; each landmark is
    observed from `obs_per_lm` nearby poses, wrapping around the trajectory
    (not clipped: clipping piles observations onto one pose). Landmark ids
    in first-observed-pose order and observations in pose-major order, as
    tracks.build_ba_problem emits real problems. `clean` masks observations
    whose geometry is invalid (wraparound observers behind the landmark,
    projections far outside any sensor), as the at-scale accuracy test does.

    Returns the BAProblem on `device` (default cuda), and with `return_gt`
    also the noiseless trajectory and landmarks the pixels came from.
    """
    from vision_slam_frontend_tpu_torch.backend.tracks import build_gather_tables
    from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    gt_t = np.stack([np.array([0.01 * k, 0.0, 0.5 * k]) for k in range(P)])
    q0 = np.zeros((P, 4), np.float32)
    q0[:, 0] = 1.0
    lm = np.stack(
        [rng.uniform(-20, 20, L), rng.uniform(-5, 5, L), rng.uniform(0, 0.5 * P + 20, L)], axis=-1,
    )
    N = L * obs_per_lm
    base_pose = (lm[:, 2] / 0.5).astype(np.int64) % P
    lm_order = np.argsort(base_pose, kind="stable")
    lm, base_pose = lm[lm_order], base_pose[lm_order]
    obs_lm = np.repeat(np.arange(L), obs_per_lm)
    obs_pose = ((base_pose[obs_lm] - rng.integers(1, 12, N)) % P).astype(np.int32)
    order = np.argsort(obs_pose, kind="stable")
    obs_pose, obs_lm = obs_pose[order], obs_lm[order]
    rel = lm[obs_lm] - gt_t[obs_pose]
    z = np.maximum(rel[:, 2], 0.5)
    px = np.stack([500.0 * rel[:, 0] / z + 320.0, 500.0 * rel[:, 1] / z + 240.0], -1) + rng.normal(0, 0.5, (N, 2))
    valid = np.ones(N, bool)
    if clean:
        valid = (
            (rel[:, 2] >= 0.5)
            & (np.abs(px[:, 0] - 320.0) < 1000.0)
            & (np.abs(px[:, 1] - 240.0) < 1000.0)
        )
    pad = (-N) % 1024
    if pad:
        obs_pose = np.pad(obs_pose, (0, pad))
        obs_lm = np.pad(obs_lm, (0, pad))
        px = np.pad(px, ((0, pad), (0, 0)))
    mask = np.zeros(N + pad, bool)
    mask[:N] = valid
    pose_obs, pose_obs_mask, lm_obs, lm_obs_mask = build_gather_tables(obs_pose, obs_lm, mask, P, L)
    prob = BAProblem.from_numpy(dict(
        poses_t=gt_t + rng.normal(0, 0.05, gt_t.shape),
        poses_q=q0,
        pose_mask=np.ones(P, bool),
        landmarks=lm + rng.normal(0, 0.2, lm.shape),
        landmark_mask=np.ones(L, bool),
        obs_pose=obs_pose,
        obs_landmark=obs_lm,
        obs_pixel=px,
        obs_mask=mask,
        **_odometry_chain(P, np.tile([0.01, 0, 0.5], (P - 1, 1)), q0[: P - 1]),
        pose_obs=pose_obs,
        pose_obs_mask=pose_obs_mask,
        lm_obs=lm_obs,
        lm_obs_mask=lm_obs_mask,
    ), device=device)
    if return_gt:
        return prob, gt_t, lm
    return prob
