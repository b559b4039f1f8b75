"""FREAK-class binary descriptors: retinal sampling pattern, 512 bits
(port of ops/freak.py).

43 receptive fields (a foveal centre and 7 rings of 6 points, radii in
geometric progression, overlapping fields whose sigma grows with the
radius), sampled from 7 Gaussian-blurred planes through one patch-kernel
call (C=7, 27x27, f32). The 512 bits compare field pairs coarse to fine
(largest combined field size first); the orientation comes from the
symmetric opposite-field pairs. The sampling engine is BRISK's
(ops/brisk.ring_describe), specialised by these constants.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops.brief import extract_over_levels
from vision_slam_frontend_tpu_torch.ops.brisk import (  # the patch constants are the reference's freak ones too
    PATCH_AREA,  # noqa: F401
    PATCH_RADIUS,
    PATCH_SIZE,  # noqa: F401
    RingPattern,
    blurred_patches,
    plane_flat_indices,
    ring_describe,
    steering_table,
)

_N_RINGS = 7
_PTS_PER_RING = 6
_R_OUTER = 11.0
_R_FACTOR = 0.7
RINGS = tuple(
    (
        _R_OUTER * _R_FACTOR**k,
        _PTS_PER_RING,
        max(0.45 * _R_OUTER * _R_FACTOR**k, 0.6),
    )
    for k in range(_N_RINGS)
) + ((0.0, 1, 0.6),)
NUM_POINTS = _N_RINGS * _PTS_PER_RING + 1  # 43
NUM_BITS = 512
NUM_WORDS = NUM_BITS // 32  # 16
BORDER = PATCH_RADIUS + 4


def _pattern() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(43, 2) float32 offsets (x, y), (43,) int32 sigma-plane index,
    (43,) float32 per-point sigma."""
    pts, plane, sig = [], [], []
    sigmas: list[float] = []
    for s, (r, n, sigma) in enumerate(RINGS):
        if sigma not in sigmas:
            sigmas.append(sigma)
        for k in range(n):
            th = 2.0 * np.pi * (k + 0.5 * (s % 2)) / n
            pts.append((r * np.cos(th), r * np.sin(th)))
            plane.append(sigmas.index(sigma))
            sig.append(sigma)
    return (
        np.asarray(pts, np.float32),
        np.asarray(plane, np.int32),
        np.asarray(sig, np.float32),
    )


_POINTS, _PLANE, _SIGMA = _pattern()
SIGMAS = tuple(dict.fromkeys(s for _, _, s in RINGS))  # unique, ring order
NUM_PLANES = len(SIGMAS)  # 7


def _pairs() -> tuple[np.ndarray, np.ndarray]:
    """(bit pairs (512, 2): all 903 pairs by decreasing combined field size,
    ties by decreasing distance, the first 512; orientation pairs: opposite
    points within each ring)."""
    idx_a, idx_b, key = [], [], []
    for i in range(NUM_POINTS):
        for j in range(i + 1, NUM_POINTS):
            idx_a.append(i)
            idx_b.append(j)
            d = float(np.linalg.norm(_POINTS[i] - _POINTS[j]))
            key.append((-(float(_SIGMA[i]) + float(_SIGMA[j])), -d))
    order = sorted(range(len(key)), key=lambda q: key[q])
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    bits = np.stack([idx_a[order[:NUM_BITS]], idx_b[order[:NUM_BITS]]], 1).astype(np.int32)
    orient = []
    base = 0
    for r, n, _sigma in RINGS:
        if n >= 2 and r > 0:
            for k in range(n // 2):
                orient.append((base + k, base + k + n // 2))
        base += n
    return bits, np.asarray(orient, np.int32)


_BIT_PAIRS, _ORIENT_PAIRS = _pairs()


def _gradient_weights() -> np.ndarray:
    """(43, 2) G with g = V @ G the symmetric-pair gradient sum:
    g = mean (V_a - V_b) (p_a - p_b) / ||p_a - p_b||."""
    G = np.zeros((NUM_POINTS, 2), np.float64)
    for a, b in _ORIENT_PAIRS:
        dp = _POINTS[a] - _POINTS[b]
        w = dp / max(float(np.linalg.norm(dp)), 1e-9)
        G[a] += w
        G[b] -= w
    G /= max(len(_ORIENT_PAIRS), 1)
    return G.astype(np.float32)


PATTERN = RingPattern(
    idx0=plane_flat_indices(_POINTS, _PLANE.astype(np.int64), 0.0),
    grad_w=_gradient_weights(),
    table=steering_table(_POINTS, _PLANE.astype(np.int64)),
    pairs=_BIT_PAIRS,
)


def freak_describe(
    image: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """FREAK-class descriptors of a (H, W) float32 image. Returns
    (descriptors (K, 16) int32, coarse-to-fine bit order; orientations (K,)
    f32)."""
    return ring_describe(blurred_patches(image, keypoints, SIGMAS), valid, PATTERN)


def detect_and_describe_freak(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = BORDER,
    nms: bool = True,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
    scale_factor: float = 1.4,
):
    """Registry extractor: FAST detect (`nms` as fast_detect's) ->
    FREAK-class describe on a (H, W) uint8 image (the reference's FREAK
    branch pairs FREAK with FAST).
    `blur_sigma` is unused (the smoothing is per field).

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 16) int32,
    valid (K,))."""
    del blur_sigma
    return extract_over_levels(lambda img, kps, valid: freak_describe(img, kps, valid)[0], image, threshold,
                               max_keypoints, max(border, BORDER), num_levels, scale_factor, nms)
