"""AKAZE-class descriptor family: nonlinear scale space + MLDB binary bits
(port of ops/akaze.py; the reference's default extractor).

  - Scale space: a SIGMA0 Gaussian blur, then explicit Perona-Malik
    diffusion steps (g2 conductivity, 4-neighbour stencil, edge-replicate
    boundary) up to each level's evolution time, in float32 and in the
    reference's order of operations. The contrast k is the 70th percentile
    (linear) of the base level's gradient magnitude.
  - Detection: the sigma^4-normalised Hessian determinant per level, strict
    3x3 NMS, threshold^2, an exact top-K and the sub-pixel fit
    (ops/fast.top_k_subpixel). Octaveless: every level is full resolution.
  - Description (MLDB): the 31x31 patches of (L, Lx, Ly) through one
    patch-kernel call (C=3, f32); the orientation from the Gaussian-disk mean
    gradient; cell means over 2x2 + 3x3 + 4x4 grids for every rotation bin;
    486 pair comparisons padded to 512 bits.

The reference's float32 products (orientation sums, cell means) sum in an
order XLA chooses. Here they sum in float64 and round once to float32: the
inputs are the reference's bf16-exact hi/lo parts, so every product is
exact, and the CPU and the card give the same bits. The bin rotation's cos
and sin are a host table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vision_slam_frontend_tpu_torch.ops.brief import (
    NUM_BINS,
    PATCH_RADIUS,
    PATCH_SIZE,
    concat_levels,
    level_budgets,
    pack_bits,
    quantize_angle,
)
from vision_slam_frontend_tpu_torch.ops.cuda_kernels import extract_patches
from vision_slam_frontend_tpu_torch.ops.fast import interior, top_k_subpixel
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

PATCH_AREA = PATCH_SIZE * PATCH_SIZE  # 961
SIGMA0 = 1.6  # base evolution scale
TAU = 0.20  # explicit diffusion step
GRIDS = (2, 3, 4)  # MLDB cell grids
NUM_CELLS = sum(g * g for g in GRIDS)  # 29
NUM_CHANNELS = 3  # L, Lx', Ly'
NUM_BITS = 512  # 486 pair bits + 26 zero pad -> 16 words
NUM_WORDS = NUM_BITS // 32
BORDER = PATCH_RADIUS + 4
THRESHOLD_GAIN = 1.0  # response threshold = gain * threshold^2
CONTRAST_PERCENTILE = 70.0


def _cell_weights() -> np.ndarray:
    """(PATCH_AREA, NUM_BINS * NUM_CELLS) f32 rotated cell-mean weights:
    column (b, c) averages the disk pixels whose offsets, rotated by -theta_b
    into the feature frame, fall in cell c."""
    R = PATCH_RADIUS
    dy, dx = np.mgrid[-R : R + 1, -R : R + 1]
    dx = dx.ravel().astype(np.float64)
    dy = dy.ravel().astype(np.float64)
    disk = dx * dx + dy * dy <= R * R
    out = np.zeros((PATCH_AREA, NUM_BINS * NUM_CELLS), np.float64)
    for b in range(NUM_BINS):
        th = 2.0 * np.pi * b / NUM_BINS
        c, s = np.cos(th), np.sin(th)
        xr = c * dx + s * dy
        yr = -s * dx + c * dy
        base = 0
        for g in GRIDS:
            cw = 2.0 * R / g
            cx = np.clip(((xr + R) / cw).astype(np.int64), 0, g - 1)
            cy = np.clip(((yr + R) / cw).astype(np.int64), 0, g - 1)
            cell = cy * g + cx
            for cc in range(g * g):
                m = disk & (cell == cc)
                n = m.sum()
                if n:
                    out[m, b * NUM_CELLS + base + cc] = 1.0 / n
            base += g * g
    return out.astype(np.float32)


def _cell_pairs() -> np.ndarray:
    """(162, 2) within-grid cell index pairs (global cell ids)."""
    pairs = []
    base = 0
    for g in GRIDS:
        n = g * g
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append((base + i, base + j))
        base += n
    return np.asarray(pairs, np.int32)


def _orientation_weights() -> np.ndarray:
    """(PATCH_AREA,) Gaussian disk weights of the mean-gradient orientation."""
    R = PATCH_RADIUS
    dy, dx = np.mgrid[-R : R + 1, -R : R + 1]
    r2 = (dx * dx + dy * dy).astype(np.float64)
    w = np.exp(-r2 / (2.0 * (0.5 * R) ** 2)) * (r2 <= R * R)
    return (w / w.sum()).ravel().astype(np.float32)


def _bf16_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's hi/lo bf16 split of float32 values, as float32."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(torch.float32)).to(torch.bfloat16)
    return hi.to(torch.float32), lo.to(torch.float32)


def _describe_tables() -> dict[str, np.ndarray]:
    w = torch.from_numpy(_cell_weights())
    w_hi, w_lo = _bf16_split(w)
    # The reference sums hi.Whi + hi.Wlo + lo.Whi = [hi, lo] @ [Whi + Wlo; Whi]
    # (Whi + Wlo is exact in float32: two 8-bit mantissas).
    cell_w = torch.cat([w_hi + w_lo, w_hi]).to(torch.float64).numpy()
    th = np.arange(NUM_BINS, dtype=np.float32) * np.float32(2.0 * np.pi / NUM_BINS)
    pairs = _cell_pairs()
    return {
        "cell_w": cell_w,  # (2 * PATCH_AREA, NUM_BINS * NUM_CELLS) f64
        "ori_w": _orientation_weights().astype(np.float64),  # (PATCH_AREA,)
        "cos": np.cos(th.astype(np.float64)).astype(np.float32),  # (NUM_BINS,)
        "sin": np.sin(th.astype(np.float64)).astype(np.float32),
        "pair_a": pairs[:, 0].astype(np.int64),
        "pair_b": pairs[:, 1].astype(np.int64),
    }


_HOST_TABLES = _describe_tables()
_DEVICE_TABLES: dict[torch.device, dict[str, torch.Tensor]] = {}


def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    """The describe tables on `device`, uploaded once per device."""
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        tabs = {k: torch.from_numpy(v).to(device) for k, v in _HOST_TABLES.items()}
        _DEVICE_TABLES[device] = tabs
    return tabs


# ---------------------------------------------------------------------------
# Nonlinear scale space
# ---------------------------------------------------------------------------


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbour view with edge-replicate boundary."""
    H, W = a.shape
    p = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def grad_central(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gx = 0.5 * (_shift(a, 0, 1) - _shift(a, 0, -1))
    gy = 0.5 * (_shift(a, 1, 0) - _shift(a, -1, 0))
    return gx, gy


def _diffusion_step(L: torch.Tensor, k2: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit Perona-Malik step: L += tau * div(g(|grad L|) grad L)."""
    gx, gy = grad_central(L)
    g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
    flux = (
        (_shift(g, 0, 1) + g) * (_shift(L, 0, 1) - L)
        + (_shift(g, 0, -1) + g) * (_shift(L, 0, -1) - L)
        + (_shift(g, 1, 0) + g) * (_shift(L, 1, 0) - L)
        + (_shift(g, -1, 0) + g) * (_shift(L, -1, 0) - L)
    )
    return L + (0.5 * tau) * flux


def contrast_k2(L0: torch.Tensor) -> torch.Tensor:
    """k^2 from the 70th percentile (linear) of the interior gradient
    magnitude, as jnp.percentile computes it: the sorted values at floor and
    ceil of q (n - 1), q = 0.7 in float32, weighted (weights from the static
    size, on the host) and summed in float64, rounded once."""
    gx, gy = grad_central(L0)
    mag = torch.sqrt(gx * gx + gy * gy)[3:-3, 3:-3].reshape(-1)
    n = mag.numel()
    q = np.float32(np.float32(CONTRAST_PERCENTILE) / np.float32(100.0)) * np.float32(n - 1)
    low, high = int(np.floor(q)), int(np.ceil(q))
    w_high = np.float32(q - np.float32(low))
    w_low = np.float32(1.0) - w_high
    ordered = torch.sort(mag).values
    k = ordered[low].to(torch.float64) * float(w_low) + ordered[high].to(torch.float64) * float(w_high)
    k = torch.clamp(k.to(torch.float32), min=1e-3)
    return k * k


def evolution_sigmas(num_levels: int, scale_factor: float) -> list[float]:
    """Per-level evolution scales: sigma_i = SIGMA0 * scale_factor^(i+1)."""
    return [SIGMA0 * (scale_factor ** (i + 1)) for i in range(num_levels)]


def build_scale_space(image: torch.Tensor, num_levels: int, scale_factor: float) -> list[torch.Tensor]:
    """`num_levels` full-resolution evolution images of a (H, W) f32 image."""
    L = gaussian_blur(image.to(torch.float32), sigma=SIGMA0)
    k2 = contrast_k2(L)
    levels = []
    t_prev = 0.5 * SIGMA0 * SIGMA0
    for sigma in evolution_sigmas(num_levels, scale_factor):
        t_next = 0.5 * sigma * sigma
        n_steps = max(1, int(math.ceil((t_next - t_prev) / TAU)))
        tau = (t_next - t_prev) / n_steps
        for _ in range(n_steps):
            L = _diffusion_step(L, k2, tau)
        levels.append(L)
        t_prev = t_next
    return levels


# ---------------------------------------------------------------------------
# Hessian-determinant detection
# ---------------------------------------------------------------------------


def hessian_response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """sigma^4-normalised determinant-of-Hessian response map."""
    Lx, Ly = grad_central(L)
    Lxx, Lxy = grad_central(Lx)
    _, Lyy = grad_central(Ly)
    return (sigma ** 4) * (Lxx * Lyy - Lxy * Lxy)


def detect_on_response(resp: torch.Tensor, threshold, max_keypoints: int, border: int):
    """Strict 3x3 NMS (-inf outside the map), the border and threshold
    cuts, then the exact top-K and sub-pixel fit of ops/fast."""
    H, W = resp.shape
    padded = F.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    neigh = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = padded[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            neigh = n if neigh is None else torch.maximum(neigh, n)
    score = torch.where(resp > neigh, resp, float("-inf"))
    score = torch.where(interior(resp, border) & (score > threshold), score, float("-inf"))
    return top_k_subpixel(score, resp, max_keypoints)


# ---------------------------------------------------------------------------
# MLDB description
# ---------------------------------------------------------------------------


def akaze_describe(
    L: torch.Tensor, Lx: torch.Tensor, Ly: torch.Tensor,
    keypoints: torch.Tensor, valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MLDB-style 486-bit descriptors from one evolution level's (H, W) f32
    channels. Returns (descriptors (K, 16) int32, zero rows for invalid
    keypoints; orientations (K,) f32)."""
    tabs = _tables(L.device)
    K = keypoints.shape[0]
    p3 = extract_patches(torch.stack([L, Lx, Ly]), keypoints, PATCH_SIZE)  # (K, 3, 961)

    # Orientation: the Gaussian-disk mean gradient.
    g = (p3[:, 1:].to(torch.float64) @ tabs["ori_w"]).to(torch.float32)  # (K, 2): gx, gy
    theta = torch.atan2(g[:, 1].to(torch.float64), g[:, 0].to(torch.float64)).to(torch.float32)
    theta = torch.where(valid, theta, 0.0)
    bins = quantize_angle(theta)

    # Cell means of every channel for every bin, then each keypoint's bin.
    hi, lo = _bf16_split(p3)
    parts = torch.cat([hi, lo], dim=2).to(torch.float64)  # (K, 3, 2 * 961)
    means = (parts @ tabs["cell_w"]).to(torch.float32).reshape(K, NUM_CHANNELS, NUM_BINS, NUM_CELLS)
    sel = bins[:, None, None, None].expand(K, NUM_CHANNELS, 1, NUM_CELLS)
    mL, mX, mY = means.gather(2, sel)[:, :, 0].unbind(1)  # (K, 29) each

    # The gradient channels in the feature frame (the bin's angle).
    c = tabs["cos"][bins][:, None]
    s = tabs["sin"][bins][:, None]
    mXr = c * mX + s * mY
    mYr = -s * mX + c * mY

    pa, pb = tabs["pair_a"], tabs["pair_b"]
    bits = torch.cat([ch.index_select(1, pa) > ch.index_select(1, pb) for ch in (mL, mXr, mYr)], dim=1)
    bits = F.pad(bits, (0, NUM_BITS - bits.shape[1]))
    return torch.where(valid[:, None], pack_bits(bits), 0), theta


# ---------------------------------------------------------------------------
# Registry extractor
# ---------------------------------------------------------------------------


def detect_and_describe_akaze(
    image: torch.Tensor,
    threshold: float | torch.Tensor = 10.0,
    max_keypoints: int = 512,
    border: int = BORDER,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
    scale_factor: float = 1.4,
):
    """Registry extractor: nonlinear scale space -> Hessian detect -> MLDB
    describe on a (H, W) uint8 image. `threshold` (FAST intensity units) is
    mapped to the response scale as THRESHOLD_GAIN * threshold^2;
    `num_levels` counts evolution levels and `scale_factor` is their sigma
    ratio; `blur_sigma` is unused (the diffusion is the smoothing).

    Returns (keypoints (K, 2), scores (K,), descriptors (K, 16) int32,
    valid (K,))."""
    del blur_sigma
    border = max(border, BORDER)
    num_levels = max(num_levels, 1)
    resp_thresh = THRESHOLD_GAIN * threshold * threshold
    levels = build_scale_space(image.to(torch.float32), num_levels, scale_factor)
    sigmas = evolution_sigmas(num_levels, scale_factor)
    per_level = []
    for L, sigma, lvl_budget in zip(levels, sigmas, level_budgets(max_keypoints, num_levels)):
        kps, scores, valid = detect_on_response(hessian_response(L, sigma), resp_thresh, lvl_budget, border)
        Lx, Ly = grad_central(L)
        desc, _ = akaze_describe(L, Lx, Ly, kps, valid)
        per_level.append((kps, scores, desc, valid))
    if num_levels == 1:
        return per_level[0]
    return concat_levels(per_level)
