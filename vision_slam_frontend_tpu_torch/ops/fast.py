"""FAST-9 corner detection (port of ops/fast.py).

The score map and the strict 3x3 NMS come from the FAST kernel
(ops/cuda_kernels.fast_scores_nms); this module masks the borders, applies
the threshold, takes the exact top-K and fits the sub-pixel offsets (the
selection tail, `top_k_subpixel`, is shared with the AKAZE detector).
"""

from __future__ import annotations

import torch

from vision_slam_frontend_tpu_torch.ops.cuda_kernels import RING_OFFSETS, fast_scores_nms

__all__ = ["RING_OFFSETS", "fast_scores", "fast_detect", "interior", "top_k_subpixel"]


def fast_scores(image: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (H, W) float32 of a uint8 or float32
    image; the 3-pixel border, where the ring leaves the image, is -inf."""
    raw, _ = fast_scores_nms(image)
    return torch.where(interior(raw, 3), raw, float("-inf"))


def interior(like: torch.Tensor, margin: int) -> torch.Tensor:
    """(H, W) bool: True at least `margin` pixels from every edge."""
    H, W = like.shape
    ys = torch.arange(H, device=like.device)[:, None]
    xs = torch.arange(W, device=like.device)[None, :]
    return (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)


def fast_detect(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = 16,
):
    """Detect up to `max_keypoints` FAST-9 corners with strict NMS.

    Args:
      image: (H, W) uint8, or float32 (a resized pyramid level).
      threshold: FAST intensity threshold (a float or a 0-d tensor).
      max_keypoints: top-K capacity.
      border: exclude keypoints within this many pixels of the edge.

    Returns:
      keypoints (K, 2) float32 (x, y), zeros for padding;
      scores (K,) float32, 0 for padding;
      valid (K,) bool.
    """
    raw, score = fast_scores_nms(image)
    # The kernel zero-pads where the ring leaves the image: the 3-pixel
    # border is never a corner, whatever `border` asks.
    in_border = interior(score, max(border, 3))
    score = torch.where(in_border & (score > threshold), score, float("-inf"))
    return top_k_subpixel(score, raw, max_keypoints)


def top_k_subpixel(score: torch.Tensor, raw: torch.Tensor, max_keypoints: int):
    """The detectors' selection tail: the `max_keypoints` best finite
    entries of a suppressed, thresholded (H, W) score map, each refined by a
    1-D quadratic fit on the raw response along each axis.

    Exact top-K with lax.top_k's order: higher score first, lower flat index
    first among equal scores (FAST scores of a uint8 image are integers, so
    ties at the K-th cut are common). A stable descending sort gives exactly
    that; `torch.topk` has no tie order.

    Returns (keypoints (K, 2) f32 (x, y), zeros for padding; scores (K,)
    f32, 0 for padding; valid (K,) bool)."""
    H, W = score.shape
    top_scores, top_idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top_scores = top_scores[:max_keypoints]
    top_idx = top_idx[:max_keypoints]
    valid = torch.isfinite(top_scores)
    kxi = top_idx % W
    kyi = top_idx // W

    # Valid keypoints lie inside the detection border, so their neighbours
    # are inside the image; padding entries are clamped and masked below.
    rflat = raw.reshape(-1)
    last = H * W - 1

    def axis_offset(idx_m, idx_p, idx_c):
        s_m = rflat[idx_m.clamp(0, last)]
        s_p = rflat[idx_p.clamp(0, last)]
        s_c = rflat[idx_c]
        denom = s_m - 2.0 * s_c + s_p
        flat = denom.abs() < 1e-6
        off = 0.5 * (s_m - s_p) / torch.where(flat, 1e-6, denom)
        return torch.where(flat, 0.0, off).clamp(-0.5, 0.5)

    ic = kyi * W + kxi
    dx = axis_offset(ic - 1, ic + 1, ic)
    dy = axis_offset(ic - W, ic + W, ic)
    kx = kxi.to(torch.float32) + dx
    ky = kyi.to(torch.float32) + dy
    keypoints = torch.where(valid[:, None], torch.stack([kx, ky], dim=-1), 0.0)
    scores = torch.where(valid, top_scores, 0.0)
    return keypoints, scores, valid
