"""Trajectory accuracy metrics: ATE / RPE with Umeyama alignment (port of
backend/metrics.py; host-side numpy, run once per evaluation)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning est -> gt.

    Args:
      est, gt: (N, 3) corresponding trajectory points.
    Returns (R (3,3), t (3,), s): gt ~ s * R @ est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, align: bool = True, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE (metres) after optional alignment."""
    est = np.asarray(est, np.float64).reshape(-1, 3)
    gt = np.asarray(gt, np.float64).reshape(-1, 3)
    if align and len(est) >= 3:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over `delta`-step pairs."""
    est = np.asarray(est, np.float64).reshape(-1, 3)
    gt = np.asarray(gt, np.float64).reshape(-1, 3)
    n = len(est) - delta
    if n <= 0:
        return 0.0
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=-1)
    return float(np.sqrt(np.mean(err**2)))
