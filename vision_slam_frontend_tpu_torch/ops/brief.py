"""Rotation-steered BRIEF (ORB-class) binary descriptors (port of ops/brief.py).

One pyramid level. Per keypoint: the 31x31 patch of the f16-quantized
blurred image (the patch kernel, ops/cuda_kernels.extract_patches), its
intensity-centroid angle, the angle's rotation bin, and the bin's 256 pair
comparisons packed into 8 words. Descriptor words are int32 tensors holding
the reference's uint32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops.cuda_kernels import extract_patches
from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

PATCH_RADIUS = 15  # 31x31 patch, as in ORB
NUM_BITS = 256
NUM_BINS = 32  # rotation quantization
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 31
PATCH_DTYPE = torch.float16  # patch payload precision (the reference's PATCH_DTYPE)


def brief_pattern(seed: int = 7, num_bits: int = NUM_BITS, radius: int = PATCH_RADIUS) -> np.ndarray:
    """Deterministic BRIEF sampling pattern: (num_bits, 2, 2) float32 of
    (x, y) offsets, N(0, (radius/2.5)^2) clipped to norm <= radius - 2."""
    rng = np.random.RandomState(seed)
    sigma = radius / 2.5
    pts = rng.normal(0.0, sigma, size=(num_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    lim = radius - 2
    pts = np.where(norm > lim, pts * (lim / np.maximum(norm, 1e-9)), pts)
    return pts.astype(np.float32)


_PATTERN = brief_pattern()


def _rotated_patterns() -> np.ndarray:
    """Integer sample offsets per rotation bin: (NUM_BINS, 256, 2 pts, 2)
    int32, [..., 0] = dx and [..., 1] = dy, rotated by the bin angle and
    rounded; every offset stays inside the patch."""
    out = np.zeros((NUM_BINS, NUM_BITS, 2, 2), np.int32)
    px, py = _PATTERN[..., 0], _PATTERN[..., 1]
    for b in range(NUM_BINS):
        th = 2.0 * np.pi * b / NUM_BINS
        c, s = np.cos(th), np.sin(th)
        out[b, ..., 0] = np.rint(c * px - s * py)
        out[b, ..., 1] = np.rint(s * px + c * py)
    return out


_ROT_PATTERNS = _rotated_patterns()
# Flat patch-local indices of each bin's pair members: (NUM_BINS, 256).
_ROT_A = (
    (_ROT_PATTERNS[:, :, 0, 1] + PATCH_RADIUS) * PATCH_SIZE
    + (_ROT_PATTERNS[:, :, 0, 0] + PATCH_RADIUS)
).astype(np.int32)
_ROT_B = (
    (_ROT_PATTERNS[:, :, 1, 1] + PATCH_RADIUS) * PATCH_SIZE
    + (_ROT_PATTERNS[:, :, 1, 0] + PATCH_RADIUS)
).astype(np.int32)


def _moment_weights() -> tuple[np.ndarray, np.ndarray]:
    """Circular-disk intensity-centroid weights over the flat 31x31 patch."""
    dy, dx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    mask = (dx * dx + dy * dy) <= PATCH_RADIUS * PATCH_RADIUS
    wx = (dx * mask).ravel().astype(np.float32)
    wy = (dy * mask).ravel().astype(np.float32)
    return wx, wy


_MOMENT_WX, _MOMENT_WY = _moment_weights()

_DEVICE_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(moment weights (961, 2) f64, ROT_A, ROT_B (32, 256) int64) on
    `device`, uploaded once per device so the step itself copies nothing
    from the host."""
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        w = np.stack([_MOMENT_WX, _MOMENT_WY], axis=1).astype(np.float64)
        tabs = (
            torch.from_numpy(w).to(device),
            torch.from_numpy(_ROT_A.astype(np.int64)).to(device),
            torch.from_numpy(_ROT_B.astype(np.int64)).to(device),
        )
        _DEVICE_TABLES[device] = tabs
    return tabs


def quantize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Angle (radians) -> rotation bin in [0, NUM_BINS), round half to even.

    The divisor is a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can round differently."""
    step = torch.full_like(theta, 2.0 * np.pi / NUM_BINS)
    return torch.remainder(torch.round(theta / step).to(torch.int64), NUM_BINS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 32*words) {0,1} -> (K, words) int32, little-endian per word (the
    reference's uint32 words, bit for bit)."""
    K, nbits = bits.shape
    b = bits.to(torch.int64).reshape(K, nbits // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(-1)  # in [0, 2^32)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits(packed: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(K, words) int32 -> (K, 32*words) {0,1} in `dtype`."""
    K, words = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(K, words * 32).to(dtype)


def orient_and_describe(
    image_blurred: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid orientation + steered BRIEF from one f16 patch
    extraction of the blurred image.

    The reference's CPU path computes the same quantities from the same f16
    values (compute_orientations + the "gather" brief_describe): for a valid
    keypoint every rotated sample lies inside its patch, so p[a] < p[b] on
    the patch is its bit. The moments sum exactly in float64 (f16 values
    times integer weights) and round once to float32.

    Returns (orientations (K,) f32, descriptors (K, 8) int32; zero rows for
    invalid keypoints)."""
    moment_w, rot_a, rot_b = _tables(image_blurred.device)
    planes = image_blurred.to(PATCH_DTYPE)[None]
    p = extract_patches(planes, keypoints, PATCH_SIZE)[:, 0].to(torch.float32)  # (K, 961)
    m = (p.to(torch.float64) @ moment_w).to(torch.float32)
    theta = torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), 0.0)
    bins = quantize_angle(theta)
    bits = p.gather(1, rot_a[bins]) < p.gather(1, rot_b[bins])  # (K, 256)
    packed = pack_bits(bits)
    return theta, torch.where(valid[:, None], packed, 0)


def detect_and_describe(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = PATCH_RADIUS + 4,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
):
    """FAST detect -> blur -> orient -> steered BRIEF on a (H, W) uint8 image.

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 8) int32,
    valid (K,))."""
    if num_levels != 1:
        raise NotImplementedError("image pyramid (num_levels > 1) is not ported yet")
    keypoints, scores, valid = fast_detect(
        image, threshold=threshold, max_keypoints=max_keypoints, border=border
    )
    blurred = gaussian_blur(image.to(torch.float32), sigma=blur_sigma)
    _, descriptors = orient_and_describe(blurred, keypoints, valid)
    return keypoints, scores, descriptors, valid
