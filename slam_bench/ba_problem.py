"""The offline BA cell's problem, made on the device from the seed.

The construction of the port's synthetic_ba_problem, frozen here with the
configuration's camera: a trajectory of `poses` keyframes `step_m` apart,
turning by `yaw_rate` a keyframe; `landmarks` points, each anchored ahead of
pose floor(j P / L) in a box of the traffic's `landmark_box` (camera frame,
metres) and observed in stereo by the next `obs_per_landmark` poses where it
projects inside the image; noisy pixels, initial poses (jitter and a random-walk drift) and landmarks;
odometry factors from the true relative poses. Returns numpy arrays
landmark-major, (L, O) with a validity mask, and the ground truth.
"""

from __future__ import annotations

import numpy as np
import torch


def _rot(yaw: torch.Tensor) -> torch.Tensor:
    """(K,) -> (K, 3, 3) world-from-camera, a yaw about camera y."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)], -2)


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    cam = config["camera"]
    P, L, O = traffic["poses"], traffic["landmarks"], traffic["obs_per_landmark"]
    fx, fy, cx, cy = (cam["left"][k] for k in ("fx", "fy", "cx", "cy"))
    W, H, b = cam["width"], cam["height"], cam["baseline_m"]
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    f64 = dict(dtype=torch.float64, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, **f64)

    def normal(sigma, *shape):
        return sigma * torch.randn(*shape, generator=g, **f64)

    yaw = traffic["yaw_rate"] * torch.arange(P, **f64)
    fwd = torch.stack([torch.sin(yaw), torch.zeros_like(yaw), torch.cos(yaw)], -1)
    gt_t = torch.cat([torch.zeros(1, 3, **f64), torch.cumsum(traffic["step_m"] * fwd[:-1], 0)])
    Rw = _rot(yaw)
    anchor = (torch.arange(L, device=dev) * P) // L
    box = traffic["landmark_box"]
    local = torch.stack([uniform(*box[0], L), uniform(*box[1], L), uniform(*box[2], L)], -1)
    gt_lm = gt_t[anchor] + torch.einsum("lij,lj->li", Rw[anchor], local)
    obs_pose = torch.clamp(anchor[:, None] + torch.arange(O, device=dev)[None, :], max=P - 1)
    rel = gt_lm[:, None, :] - gt_t[obs_pose]
    p_cam = torch.einsum("loji,loj->loi", Rw[obs_pose], rel)
    z = p_cam[..., 2].clamp(min=1e-6)
    u = fx * p_cam[..., 0] / z + cx
    v = fy * p_cam[..., 1] / z + cy
    valid = (p_cam[..., 2] > 0.5) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = obs_pose[:, 1:] == obs_pose[:, :-1]
    valid &= ~dup
    px = torch.stack([u, v], -1) + normal(traffic["px_noise"], L, O, 2)
    px_r = torch.stack([u - fx * b / z, v], -1) + normal(traffic["px_noise"], L, O, 2)
    init_t = gt_t + normal(traffic["pose_noise"], P, 3) + torch.cumsum(normal(traffic["pose_walk"], P, 3), 0)
    init_t[0] = gt_t[0]
    dyaw = normal(traffic["pose_noise"] * 0.3, P) + torch.cumsum(normal(traffic["pose_walk"] * 0.1, P), 0)
    dyaw[0] = 0.0
    yi = yaw + dyaw
    init_q = torch.stack([torch.cos(yi / 2), torch.zeros_like(yi), torch.sin(yi / 2), torch.zeros_like(yi)], -1)
    init_lm = gt_lm + normal(traffic["landmark_noise"], L, 3)
    dy = yaw[1:] - yaw[:-1]
    odom_t = torch.einsum("qji,qj->qi", Rw[:-1], gt_t[1:] - gt_t[:-1])
    odom_q = torch.stack([torch.cos(dy / 2), torch.zeros_like(dy), torch.sin(dy / 2), torch.zeros_like(dy)], -1)
    out = dict(poses_t=init_t, poses_q=init_q, landmarks=init_lm, obs_pose=obs_pose, obs_valid=valid,
               pixel=px, pixel_right=px_r, odom_t=odom_t, odom_q=odom_q, gt_t=gt_t, gt_lm=gt_lm)
    return {k: v.cpu().numpy() for k, v in out.items()}


def camera(config: dict) -> dict:
    cam = config["camera"]
    return dict(fx=cam["left"]["fx"], fy=cam["left"]["fy"], cx=cam["left"]["cx"], cy=cam["left"]["cy"],
                fx_r=cam["right"]["fx"], fy_r=cam["right"]["fy"], cx_r=cam["right"]["cx"], cy_r=cam["right"]["cy"],
                baseline=cam["baseline_m"])


def program_arrays(prob: dict) -> dict:
    """The flat arrays the port's BAProblem takes: valid observations in
    landmark-major order, the odometry chain, all masks set."""
    L, O = prob["obs_valid"].shape
    keep = prob["obs_valid"].reshape(-1)
    P = prob["poses_t"].shape[0]
    obs_lm = np.broadcast_to(np.arange(L)[:, None], (L, O)).reshape(-1)[keep]
    n = int(keep.sum())
    return dict(
        poses_t=prob["poses_t"].astype(np.float32), poses_q=prob["poses_q"].astype(np.float32),
        pose_mask=np.ones(P, bool), landmarks=prob["landmarks"].astype(np.float32), landmark_mask=np.ones(L, bool),
        obs_pose=prob["obs_pose"].reshape(-1)[keep].astype(np.int32), obs_landmark=obs_lm.astype(np.int32),
        obs_pixel=prob["pixel"].reshape(-1, 2)[keep].astype(np.float32),
        obs_pixel_right=prob["pixel_right"].reshape(-1, 2)[keep].astype(np.float32),
        obs_mask=np.ones(n, bool), obs_right_mask=np.ones(n, bool),
        odom_i=np.arange(P - 1), odom_j=np.arange(1, P), odom_t=prob["odom_t"].astype(np.float32),
        odom_q=prob["odom_q"].astype(np.float32), odom_mask=np.ones(P - 1, bool),
    )
