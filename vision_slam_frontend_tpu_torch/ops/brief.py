"""Rotation-steered BRIEF (ORB-class) binary descriptors (port of ops/brief.py).

Per keypoint and pyramid level: the 31x31 patch of the f16-quantized
blurred image (the patch kernel, ops/cuda_kernels.extract_patches), its
intensity-centroid angle, the angle's rotation bin, and the bin's 256 pair
comparisons packed into 8 words. Descriptor words are int32 tensors holding
the reference's uint32 bit patterns.

The frontend runs the fused `orient_and_describe`. The reference's two-step
API is here too: `compute_orientations` and `brief_describe` (its "gather"
method samples the image point by point and launches no kernel; "mxu" reads
one patch per keypoint), and `extract_patches`, the reference's (H, W[, C])
patch contract over the patch kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops.cuda_kernels import extract_patches as _extract_planes
from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur, resize_linear
from vision_slam_frontend_tpu_torch.utils.profiling import span

PATCH_RADIUS = 15  # 31x31 patch, as in ORB
NUM_BITS = 256
NUM_WORDS = NUM_BITS // 32  # 8
NUM_BINS = 32  # rotation quantization
NUM_FINE = NUM_BINS // 4  # rotation bins per 90-degree quadrant
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 31
PATCH_AREA = PATCH_SIZE * PATCH_SIZE  # 961
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

_DEVICE_TABLES: dict[torch.device, tuple[torch.Tensor, ...]] = {}


def _tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """(moment weights (961, 2) f64, ROT_A, ROT_B (32, 256) int64, the
    rotated offsets (32, 256, 2, 2) int64) on `device`, uploaded once per
    device so the step itself copies nothing from the host."""
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        w = np.stack([_MOMENT_WX, _MOMENT_WY], axis=1).astype(np.float64)
        tabs = tuple(
            torch.from_numpy(a).to(device)
            for a in (w, _ROT_A.astype(np.int64), _ROT_B.astype(np.int64), _ROT_PATTERNS.astype(np.int64))
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


def extract_patches(image: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """Flat 31x31 patches centered at round(keypoint), the reference's
    contract: (H, W) -> (K, 961), (H, W, C) -> (K, 961, C), in the image's
    dtype. Patch k starts at clip(round(kp) - 15, 0, dim - 31), rounding half
    to even, so a keypoint near or outside the edge reads the patch at the
    edge. One patch-kernel launch with the image as (C, H, W) planes.

    float16 and float32 go through the kernel as they are, uint8 through
    float32 and back (exact); other dtypes are refused."""
    if image.dim() not in (2, 3):
        raise ValueError(f"extract_patches: expected a (H, W) or (H, W, C) image, got {tuple(image.shape)}")
    dtype = image.dtype
    if dtype == torch.uint8:
        image = image.to(torch.float32)
    elif dtype not in (torch.float16, torch.float32):
        raise ValueError(f"extract_patches: unsupported dtype {dtype} (float16, float32 or uint8)")
    planes = image[None] if image.dim() == 2 else image.permute(2, 0, 1)
    p = _extract_planes(planes.contiguous(), keypoints.to(torch.float32).contiguous(), PATCH_SIZE)
    p = p[:, 0] if image.dim() == 2 else p.transpose(1, 2).contiguous()
    return p.to(dtype)


def _f16_patches(image: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """(K, 961) f32: each keypoint's patch of the image quantized to
    PATCH_DTYPE (through float32, as the reference casts), one kernel launch."""
    planes = image.to(torch.float32).to(PATCH_DTYPE)[None]
    return _extract_planes(planes, keypoints.to(torch.float32).contiguous(), PATCH_SIZE)[:, 0].to(torch.float32)


def _centroid_angles(p: torch.Tensor, valid: torch.Tensor, moment_w: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles of flat patches: the disk moments summed
    exactly in float64 (f16 values times integer weights) and rounded once
    to float32; 0 for invalid keypoints."""
    m = (p.to(torch.float64) @ moment_w).to(torch.float32)
    return torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), 0.0)


def compute_orientations(image: torch.Tensor, keypoints: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per keypoint, theta = atan2(m01, m10)
    over the circular 31x31 patch of `image` quantized to PATCH_DTYPE (one
    patch-kernel launch). It reads the image it is given; the fused
    orient_and_describe, which the frontend runs, reads the blurred one.

    Args: image (H, W) real; keypoints (K, 2) (x, y); valid (K,) bool.
    Returns (K,) float32 radians, 0 for invalid keypoints."""
    moment_w = _tables(image.device)[0]
    return _centroid_angles(_f16_patches(image, keypoints), valid, moment_w)


def _patch_bits(p: torch.Tensor, bins: torch.Tensor, rot_a: torch.Tensor, rot_b: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool steered-BRIEF bits from flat patches: p[a] < p[b] for
    each pair of the keypoint's rotation bin."""
    return p.gather(1, rot_a[bins]) < p.gather(1, rot_b[bins])


def brief_describe(
    image_blurred: torch.Tensor,
    keypoints: torch.Tensor,
    orientations: torch.Tensor,
    valid: torch.Tensor,
    method: str = "auto",
) -> torch.Tensor:
    """Steered-BRIEF descriptors for all keypoints at once, from given
    orientations (quantized to NUM_BINS) and rounded keypoint centers, on the
    blurred image quantized to PATCH_DTYPE.

      - "gather" (and "auto", the reference's choice off the TPU): each
        sample is read from the image at round(kp) + the bin's offset,
        clipped to the image one coordinate at a time. No kernel.
      - "mxu": one patch per keypoint (the patch kernel), then the bin's
        pairs compared inside it.

    The two agree for keypoints at least 15 px inside the image; nearer the
    edge the patch's start is clipped as a whole, the gather's samples one
    by one (as in the reference).

    Returns (K, 8) int32 words (the reference's uint32 bits); zero rows for
    invalid keypoints."""
    if method not in ("auto", "gather", "mxu"):
        raise ValueError(f"brief_describe: unknown method {method!r} (auto|gather|mxu)")
    _, rot_a, rot_b, rot_offsets = _tables(image_blurred.device)
    bins = quantize_angle(orientations)
    if method == "mxu":
        bits = _patch_bits(_f16_patches(image_blurred, keypoints), bins, rot_a, rot_b)
    else:
        image_q = image_blurred.to(torch.float32).to(PATCH_DTYPE).to(torch.float32)
        H, W = image_q.shape
        offs = rot_offsets[bins]  # (K, 256, 2 pts, 2)
        kx = torch.round(keypoints[:, 0]).to(torch.int64)
        ky = torch.round(keypoints[:, 1]).to(torch.int64)
        xi = (kx[:, None, None] + offs[..., 0]).clamp(0, W - 1)
        yi = (ky[:, None, None] + offs[..., 1]).clamp(0, H - 1)
        vals = image_q.reshape(-1)[yi * W + xi]  # (K, 256, 2)
        bits = vals[..., 0] < vals[..., 1]
    return torch.where(valid[:, None], pack_bits(bits), 0)


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

    The reference's first argument, the unblurred image, is unused there
    and left out here.

    Returns (orientations (K,) f32, descriptors (K, 8) int32; zero rows for
    invalid keypoints)."""
    moment_w, rot_a, rot_b, _ = _tables(image_blurred.device)
    p = _f16_patches(image_blurred, keypoints)  # (K, 961)
    theta = _centroid_angles(p, valid, moment_w)
    packed = pack_bits(_patch_bits(p, quantize_angle(theta), rot_a, rot_b))
    return theta, torch.where(valid[:, None], packed, 0)


def level_budgets(max_keypoints: int, num_levels: int) -> list[int]:
    """The keypoint budget of each level: an even split, the last level
    taking the remainder."""
    budget = max_keypoints // num_levels
    return [budget] * (num_levels - 1) + [max_keypoints - budget * (num_levels - 1)]


def pyramid_levels(
    image: torch.Tensor, num_levels: int, scale_factor: float, border: int,
    max_keypoints: int,
):
    """The reference's image pyramid: (level image, keypoint budget, scale)
    per level. Level 0 is `image` itself; level l > 0 is the image resized
    (ops/image.resize_linear) to max(round(dim / scale), 2 * border + 8) at
    scale = scale_factor ** l. Budgets as level_budgets."""
    H, W = image.shape
    budgets = level_budgets(max_keypoints, num_levels)
    image_f = image.to(torch.float32)
    levels = [(image, budgets[0], 1.0)]
    scale = 1.0
    for lvl in range(1, num_levels):
        scale *= scale_factor
        h = max(int(round(H / scale)), 2 * border + 8)
        w = max(int(round(W / scale)), 2 * border + 8)
        levels.append((resize_linear(image_f, (h, w)), budgets[lvl], scale))
    return levels


def concat_levels(per_level):
    """Concatenate per-level (keypoints, scores, descriptors, valid) in
    level order."""
    return tuple(torch.cat(parts, dim=0) for parts in zip(*per_level))


def extract_over_levels(describe, image: torch.Tensor, threshold, max_keypoints: int, border: int,
                        num_levels: int, scale_factor: float, nms: bool = True):
    """FAST detect (`nms` as fast_detect's) -> `describe(level image f32,
    keypoints, valid) -> descriptors` on each pyramid level
    (pyramid_levels); keypoints at level-0 scale, levels concatenated in
    order. The pyramid, and each level's detect and describe, are spans."""
    per_level = []
    with span("extract.pyramid"):
        levels = pyramid_levels(image, max(num_levels, 1), scale_factor, border, max_keypoints)
    for level_img, budget, scale in levels:
        with span("extract.detect"):
            kps, scores, valid = fast_detect(level_img, threshold=threshold, max_keypoints=budget, border=border,
                                            nms=nms)
        with span("extract.describe"):
            desc = describe(level_img.to(torch.float32), kps, valid)
        per_level.append((kps * scale if scale != 1.0 else kps, scores, desc, valid))
    if len(per_level) == 1:
        return per_level[0]
    return concat_levels(per_level)


def detect_and_describe(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = PATCH_RADIUS + 4,
    nms: bool = True,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
    scale_factor: float = 1.4,
):
    """FAST detect (3x3 NMS unless `nms` is False) -> blur -> orient ->
    steered BRIEF on a (H, W) uint8 image, over `num_levels` pyramid levels;
    keypoints are reported at level-0 scale.

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 8) int32,
    valid (K,))."""

    def describe(level_img, keypoints, valid):
        return orient_and_describe(gaussian_blur(level_img, sigma=blur_sigma), keypoints, valid)[1]

    return extract_over_levels(describe, image, threshold, max_keypoints, border, num_levels, scale_factor, nms)
