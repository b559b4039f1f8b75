"""BRISK-class binary descriptors: concentric-ring pattern, 512 bits
(port of ops/brisk.py).

60 points on 5 rings, each ring sampled from its own Gaussian-blurred plane;
the five planes go through one patch-kernel call (ops/cuda_kernels.
extract_patches, C=5, 27x27, f32). Per keypoint: the orientation from the
long pairs' gradient sum, the rotation bin, the 60 rotated samples and the
512 shortest pairs' comparisons, packed into 16 words. Detection is the
shared FAST-9 detector over the pyramid (ops/brief.extract_over_levels). The
sampling engine (`RingPattern`, `ring_describe`) is shared with the FREAK
family (ops/freak.py).

How the reference's TPU formulation maps here:
  - its quadrant flips of the patch (a 90-degree rotation is an exact grid
    permutation) and its fine-bin one-hot product are two steps of one
    lookup; both fold into a (32 bins, points) table of flat patch indices,
    so a keypoint's rotated samples are one gather;
  - the one-hot product is a bf16 hi/lo split with f32 sums of exactly one
    nonzero term each, so it returns hi + lo of the sampled value; the
    gather returns the same bits;
  - the orientation sum is a float32 product whose summation order XLA
    chooses; here it sums in float64, rounds once to float32, and takes the
    angle in float64, so the CPU and the card give the same bins.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops.brief import (
    NUM_BINS,
    extract_over_levels,
    pack_bits,
    quantize_angle,
)
from vision_slam_frontend_tpu_torch.ops.cuda_kernels import extract_patches
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

NUM_FINE = NUM_BINS // 4  # fine rotation bins per 90-degree quadrant

# --- Pattern geometry: 5 rings of (radius px, points, smoothing sigma) ------
RINGS = (
    (0.0, 1, 0.6),
    (3.0, 8, 0.8),
    (5.0, 14, 1.0),
    (8.0, 17, 1.5),
    (11.0, 20, 2.0),
)
NUM_POINTS = sum(n for _, n, _ in RINGS)  # 60
NUM_BITS = 512
NUM_WORDS = NUM_BITS // 32  # 16
PATCH_RADIUS = 13  # max ring radius 11 + rotation rounding slack
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 27
PATCH_AREA = PATCH_SIZE * PATCH_SIZE  # 729
BORDER = PATCH_RADIUS + 4


def _pattern() -> tuple[np.ndarray, np.ndarray]:
    """(60, 2) float32 point offsets (x, y) + (60,) int32 ring index."""
    pts, ring = [], []
    for s, (r, n, _sigma) in enumerate(RINGS):
        for k in range(n):
            # Stagger alternate rings by half a step so points interleave.
            th = 2.0 * np.pi * (k + 0.5 * (s % 2)) / n
            pts.append((r * np.cos(th), r * np.sin(th)))
            ring.append(s)
    return np.asarray(pts, np.float32), np.asarray(ring, np.int32)


_POINTS, _RING = _pattern()


def _pairs() -> tuple[np.ndarray, np.ndarray]:
    """(short pairs (512, 2), the descriptor bits, shortest first; long
    pairs, the longest third of all 1770 pairs, for the orientation)."""
    idx_a, idx_b, d = [], [], []
    for i in range(NUM_POINTS):
        for j in range(i + 1, NUM_POINTS):
            idx_a.append(i)
            idx_b.append(j)
            d.append(np.linalg.norm(_POINTS[i] - _POINTS[j]))
    idx_a, idx_b, d = np.asarray(idx_a), np.asarray(idx_b), np.asarray(d)
    order = np.argsort(d, kind="stable")
    short = np.stack([idx_a[order[:NUM_BITS]], idx_b[order[:NUM_BITS]]], 1)
    long_cut = order[-(len(order) // 3):]
    long = np.stack([idx_a[long_cut], idx_b[long_cut]], 1)
    return short.astype(np.int32), long.astype(np.int32)


_SHORT_PAIRS, _LONG_PAIRS = _pairs()


def _gradient_weights() -> np.ndarray:
    """(60, 2) G with g = V @ G the BRISK local-gradient sum over the long
    pairs: g = mean (p_j - p_i) (V_j - V_i) / ||p_j - p_i||^2."""
    G = np.zeros((NUM_POINTS, 2), np.float64)
    for i, j in _LONG_PAIRS:
        dp = _POINTS[j] - _POINTS[i]
        w = dp / max(float(dp @ dp), 1e-9)
        G[j] += w
        G[i] -= w
    G /= max(len(_LONG_PAIRS), 1)
    return G.astype(np.float32)


def plane_flat_indices(points: np.ndarray, plane: np.ndarray, angle: float) -> np.ndarray:
    """Flat indices into a plane-stacked (planes * 27 * 27) patch of the
    points rotated by `angle` and rounded (half to even)."""
    c, s = np.cos(angle), np.sin(angle)
    px, py = points[:, 0], points[:, 1]
    dx, dy = c * px - s * py, s * px + c * py
    return (
        plane * PATCH_AREA
        + (np.rint(dy).astype(np.int64) + PATCH_RADIUS) * PATCH_SIZE
        + (np.rint(dx).astype(np.int64) + PATCH_RADIUS)
    ).astype(np.int64)


def steering_table(points: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """(NUM_BINS, points) flat patch indices of every point at every
    rotation bin, as the reference samples them: the patch rotated by the
    bin's quadrant (an exact 90-degree grid permutation), then the point
    pattern rotated by the bin's fine angle and rounded."""
    n = PATCH_SIZE
    i, j = np.divmod(np.arange(PATCH_AREA), n)
    # Source pixel of rotated pixel (i, j), per quadrant: P, then
    # P1[i, j] = P[j, n-1-i], P2[i, j] = P[n-1-i, n-1-j], P3[i, j] = P[n-1-j, i].
    quadrant_src = np.stack([
        i * n + j,
        j * n + (n - 1 - i),
        (n - 1 - i) * n + (n - 1 - j),
        (n - 1 - j) * n + i,
    ])
    out = np.zeros((NUM_BINS, len(points)), np.int64)
    for f in range(NUM_FINE):
        fine = plane_flat_indices(points, plane, 2.0 * np.pi * f / NUM_BINS)
        pl, local = np.divmod(fine, PATCH_AREA)
        for q in range(4):
            out[q * NUM_FINE + f] = pl * PATCH_AREA + quadrant_src[q][local]
    return out


@dataclasses.dataclass(frozen=True)
class RingPattern:
    """A ring-sampling descriptor's constants (numpy, host)."""

    idx0: np.ndarray  # (P,) unrotated flat patch index of each point
    grad_w: np.ndarray  # (P, 2) orientation weights: g = V @ grad_w
    table: np.ndarray  # (NUM_BINS, P) steered flat patch indices
    pairs: np.ndarray  # (512, 2) point pairs compared, bit order

    def on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(idx0, grad_w f64, table, pair a, pair b) on `device`, uploaded
        once per device."""
        tabs = _DEVICE_TABLES.get((id(self), device))
        if tabs is None:
            tabs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
                self.idx0.astype(np.int64), self.grad_w.astype(np.float64),
                self.table, self.pairs[:, 0].astype(np.int64), self.pairs[:, 1].astype(np.int64),
            ))
            _DEVICE_TABLES[(id(self), device)] = tabs
        return tabs


_DEVICE_TABLES: dict = {}


def ring_describe(
    patches: torch.Tensor, valid: torch.Tensor, pattern: RingPattern
) -> tuple[torch.Tensor, torch.Tensor]:
    """Descriptors of plane-stacked flat patches (K, planes * 729) f32.

    Returns (descriptors (K, 16) int32, zero rows for invalid keypoints;
    orientations (K,) f32 radians)."""
    idx0, grad_w, table, pa, pb = pattern.on(patches.device)
    v0 = patches.index_select(1, idx0)  # (K, P)
    g = (v0.to(torch.float64) @ grad_w).to(torch.float32)
    theta = torch.atan2(g[:, 1].to(torch.float64), g[:, 0].to(torch.float64)).to(torch.float32)
    theta = torch.where(valid, theta, 0.0)
    samples = patches.gather(1, table[quantize_angle(theta)])  # (K, P)
    # The reference's hi/lo bf16 split of each sample, recombined exactly.
    hi = samples.to(torch.bfloat16)
    lo = (samples - hi.to(torch.float32)).to(torch.bfloat16)
    v = hi.to(torch.float32) + lo.to(torch.float32)
    bits = v.index_select(1, pa) < v.index_select(1, pb)  # (K, 512)
    return torch.where(valid[:, None], pack_bits(bits), 0), theta


PATTERN = RingPattern(
    idx0=plane_flat_indices(_POINTS, _RING.astype(np.int64), 0.0),
    grad_w=_gradient_weights(),
    table=steering_table(_POINTS, _RING.astype(np.int64)),
    pairs=_SHORT_PAIRS,
)
SIGMAS = tuple(sigma for _, _, sigma in RINGS)  # one blurred plane per ring


def blurred_patches(image: torch.Tensor, keypoints: torch.Tensor, sigmas) -> torch.Tensor:
    """(K, len(sigmas) * 729) f32: one 27x27 patch per keypoint from each
    Gaussian-blurred plane, in one patch-kernel call."""
    planes = torch.stack([gaussian_blur(image, sigma=s) for s in sigmas])
    return extract_patches(planes, keypoints, PATCH_SIZE).reshape(keypoints.shape[0], -1)


def brisk_describe(
    image: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """BRISK-class descriptors of a (H, W) float32 image (smoothing is
    internal, per ring). Returns (descriptors (K, 16) int32, orientations
    (K,) f32)."""
    return ring_describe(blurred_patches(image, keypoints, SIGMAS), valid, PATTERN)


def detect_and_describe_brisk(
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
    BRISK-class describe on a (H, W) uint8 image. `blur_sigma` is accepted
    for the registry's signature and unused (the smoothing is per ring).

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 16) int32,
    valid (K,))."""
    del blur_sigma
    return extract_over_levels(lambda img, kps, valid: brisk_describe(img, kps, valid)[0], image, threshold,
                               max_keypoints, max(border, BORDER), num_levels, scale_factor, nms)
