"""SIFT-class float descriptors (port of ops/sift.py): a gradient histogram
over a 4x4 cell grid, matched by L2 distance (ops/hamming.py's float path).

Per keypoint: one float32 31x31 patch of the blurred image (the patch
kernel, ops/cuda_kernels.extract_patches, on a (1, H, W) float32 plane)
gives the intensity-centroid orientation and the descriptor. The patch is
turned by the orientation's quadrant (an exact 90-degree permutation); the
gradient angles are binned softly into 8 orientation bins relative to the
remaining fine rotation; the histogram is the contraction of the
magnitude-weighted bins with the fine rotation's spatial cell-weight table;
and the 128 values are normalized L2 -> clamp 0.2 -> L2.

The reference leaves the order of its float32 sums to XLA. Here the
orientation moments, the histogram contraction and the norms are summed in
float64 and rounded once, and the angles are float64 atan2 rounded once, so
the card and the CPU compute the same float32 values; no product is float32,
so no TF32 setting reaches this path.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops.brief import (
    _MOMENT_WX,
    _MOMENT_WY,
    NUM_BINS,
    PATCH_RADIUS,
    PATCH_SIZE,
    extract_over_levels,
    quantize_angle,
)
from vision_slam_frontend_tpu_torch.ops.cuda_kernels import extract_patches
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

GRID = 4  # 4x4 spatial cells
ORI_BINS = 8
DIMS = GRID * GRID * ORI_BINS  # 128
NUM_FINE = NUM_BINS // 4  # fine rotation bins within a quadrant
PATCH_AREA = PATCH_SIZE * PATCH_SIZE


def _spatial_weight_tables() -> np.ndarray:
    """(NUM_FINE, PATCH_AREA, GRID*GRID) float32 cell weights per fine bin:
    the bilinear tent over the 4x4 grid of the pixel offset turned by
    -theta_f, times a Gaussian window over the patch."""
    dy, dx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    dx = dx.astype(np.float64)
    dy = dy.astype(np.float64)
    gauss = np.exp(-(dx**2 + dy**2) / (2.0 * (0.5 * PATCH_SIZE) ** 2))
    cell = PATCH_SIZE / GRID
    out = np.zeros((NUM_FINE, PATCH_AREA, GRID * GRID), np.float32)
    for f in range(NUM_FINE):
        th = 2.0 * np.pi * f / NUM_BINS
        c, s = np.cos(th), np.sin(th)
        xr = c * dx + s * dy  # R(-th) p
        yr = -s * dx + c * dy
        u = xr / cell + GRID / 2 - 0.5  # continuous cell coordinates
        v = yr / cell + GRID / 2 - 0.5
        for ci in range(GRID):
            for cj in range(GRID):
                wu = np.maximum(0.0, 1.0 - np.abs(u - cj))
                wv = np.maximum(0.0, 1.0 - np.abs(v - ci))
                out[f, :, ci * GRID + cj] = (wu * wv * gauss).ravel()
    return out


_SPATIAL = _spatial_weight_tables()

_DEVICE_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor, dict]] = {}


def _tables(device: torch.device):
    """(spatial tables (PATCH_AREA, NUM_FINE*16) f64, moment weights
    (PATCH_AREA, 2) f64, float32 constants) on `device`, uploaded once per
    device so the describe copies nothing from the host."""
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        spatial = _SPATIAL.astype(np.float64).transpose(1, 0, 2).reshape(PATCH_AREA, NUM_FINE * GRID * GRID)
        moments = np.stack([_MOMENT_WX, _MOMENT_WY], axis=1).astype(np.float64)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        consts = {
            "fine_step": f32(2.0 * np.pi / NUM_BINS),
            "centers": torch.arange(ORI_BINS, dtype=torch.float32, device=device) * f32(2.0 * np.pi / ORI_BINS),
            "pi": f32(np.pi),
            "two_pi": f32(2.0 * np.pi),
            "bin_width": f32(2.0 * np.pi / ORI_BINS),
        }
        tabs = (torch.from_numpy(spatial).to(device), torch.from_numpy(moments).to(device), consts)
        _DEVICE_TABLES[device] = tabs
    return tabs


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 through float64, rounded once (the same on every device)."""
    return torch.atan2(y.to(torch.float64), x.to(torch.float64)).to(torch.float32)


def rotate_patches_90(patches: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """Rotate each flat (K, PATCH_AREA) patch by quad * 90 degrees, the exact
    grid permutation patch'(o) = patch(R(90 * quad) o): flips, transposes
    and a 3-way select."""
    K = patches.shape[0]
    p = patches.reshape(K, PATCH_SIZE, PATCH_SIZE)
    p1 = p.flip(2).transpose(1, 2)  # P1[i, j] = P[j, S-1-i]
    p2 = p.flip((1, 2))  # P2[i, j] = P[S-1-i, S-1-j]
    p3 = p.transpose(1, 2).flip(2)  # P3[i, j] = P[S-1-j, i]
    q = quad[:, None, None]
    sel = torch.where(q == 1, p1, p)
    sel = torch.where(q == 2, p2, sel)
    sel = torch.where(q == 3, p3, sel)
    return sel.reshape(K, PATCH_AREA)


def _patch_gradients(patches: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients of (K, 31, 31) patches, zero on the
    border rows and columns."""
    gx = torch.zeros_like(patches)
    gy = torch.zeros_like(patches)
    gx[:, :, 1:-1] = 0.5 * (patches[:, :, 2:] - patches[:, :, :-2])
    gy[:, 1:-1, :] = 0.5 * (patches[:, 2:, :] - patches[:, :-2, :])
    return gx, gy


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((d.to(torch.float64) ** 2).sum(-1, keepdim=True)).to(torch.float32)
    return d / n.clamp(min=1e-12)


def sift_describe_patches(patches: torch.Tensor, orientations: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(K, PATCH_AREA) float32 flat patches + orientations -> (K, 128)
    float32 descriptors, zero rows where not `valid`."""
    spatial, _, c = _tables(patches.device)
    K = patches.shape[0]
    bins = quantize_angle(orientations)
    quad = bins // NUM_FINE
    fine = bins % NUM_FINE
    prot = rotate_patches_90(patches, quad).reshape(K, PATCH_SIZE, PATCH_SIZE)
    gx, gy = _patch_gradients(prot)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(K, PATCH_AREA)
    ang = _atan2(gy, gx).reshape(K, PATCH_AREA)
    theta_f = fine.to(torch.float32) * c["fine_step"]
    rel = ang - theta_f[:, None]  # gradient angle in the keypoint's frame

    # Soft circular orientation bins: triangular weights one bin wide.
    # The reference's jnp.mod by 2 pi: fmod, then + 2 pi where negative.
    delta = torch.fmod(rel[..., None] - c["centers"] + c["pi"], c["two_pi"])  # (K, A, 8)
    delta = torch.where(delta < 0, delta + c["two_pi"], delta) - c["pi"]
    # A full-shaped divisor: CUDA divides by a scalar through its reciprocal.
    wo = (1.0 - delta.abs() / c["bin_width"].expand_as(delta)).clamp(min=0.0)
    A = mag[..., None] * wo  # (K, A, 8)

    # Every fine bin's cell histograms in one contraction, then each
    # keypoint's own bin: T[k, o, f, c] = sum_p A[k, p, o] S[f, p, c].
    T = (A.to(torch.float64).transpose(1, 2) @ spatial).reshape(K, ORI_BINS, NUM_FINE, GRID * GRID)
    D = T.gather(2, fine[:, None, None, None].expand(K, ORI_BINS, 1, GRID * GRID))[:, :, 0]  # (K, 8, 16)
    d = D.transpose(1, 2).reshape(K, DIMS).to(torch.float32)  # index cell * 8 + bin

    # SIFT normalization: L2 -> clamp 0.2 -> L2.
    d = _l2_normalize(torch.minimum(_l2_normalize(d), torch.full_like(d, 0.2)))
    return torch.where(valid[:, None], d, 0.0)


def orient_and_describe_sift(
    image_blurred: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid orientation + descriptor from one float32 patch
    extraction of the blurred image. Returns (orientations (K,) f32,
    descriptors (K, 128) f32)."""
    _, moments, _ = _tables(image_blurred.device)
    planes = image_blurred.to(torch.float32)[None].contiguous()
    patches = extract_patches(planes, keypoints.contiguous(), PATCH_SIZE)[:, 0]  # (K, 961) f32
    m = (patches.to(torch.float64) @ moments).to(torch.float32)
    theta = torch.where(valid, _atan2(m[:, 1], m[:, 0]), 0.0)
    return theta, sift_describe_patches(patches, theta, valid)


def detect_and_describe_sift(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = PATCH_RADIUS + 4,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
    scale_factor: float = 1.4,
):
    """FAST detect on the float32 image (optionally over a pyramid) ->
    centroid orientation -> gradient-histogram descriptor; keypoints at
    level-0 scale.

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 128) float32,
    valid (K,))."""

    def describe(level_img, keypoints, valid):
        return orient_and_describe_sift(gaussian_blur(level_img, sigma=blur_sigma), keypoints, valid)[1]

    return extract_over_levels(describe, image.to(torch.float32), threshold, max_keypoints, border, num_levels,
                               scale_factor)
