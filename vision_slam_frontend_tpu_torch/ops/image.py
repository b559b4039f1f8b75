"""Whole-image primitives: separable Gaussian blur (port of ops/image.py)
and the pyramid's linear resize (the reference's `jax.image.resize`).

The blur is the reference's statically unrolled shifted adds, in the same
order and in float32, not `F.conv2d`: a float32 convolution on the card goes
through cuDNN in TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_blur(image: torch.Tensor, sigma: float = 2.0, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) float32 image; zero padding,
    `radius` defaults to ceil(3 * sigma)."""
    if radius is None:
        radius = int(math.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    kk = np.exp(-0.5 * (x / float(sigma)) ** 2)
    taps = [float(w) for w in kk / kk.sum()]

    def filt(img: torch.Tensor, axis: int) -> torch.Tensor:
        pad = (0, 0, radius, radius) if axis == 0 else (radius, radius, 0, 0)
        padded = F.pad(img, pad)
        n = img.shape[axis]
        acc = None
        for i, w in enumerate(taps):
            term = padded.narrow(axis, i, n) * w
            acc = term if acc is None else acc + term
        return acc

    return filt(filt(image, 0), 1)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(...,
    method="linear")` along one axis (jax.image.scale_and_translate's
    compute_weight_mat with antialias): a triangle kernel stretched by
    1 / scale when downscaling, columns normalised to sum 1.

    The sample position (i + 0.5) / scale - 0.5 is rounded once, and the
    distance is multiplied by the kernel scale's reciprocal, as the
    reference's compiled CPU program computes them (a fused multiply-add and
    a division by a constant turned into a product): the weights then agree
    with the reference's to 1.2e-7 at the pyramid's sizes, where the
    step-by-step formula is up to 5.9e-6 off."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = f32(max(float(inv_scale), 1.0))
    centres = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (centres * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


_RESIZE_TAPS: dict[tuple[int, int, torch.device], tuple[torch.Tensor, torch.Tensor]] = {}


def _resize_taps(in_size: int, out_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The nonzero taps of `_resize_weights`, per output sample: input
    indices (T, out_size) int64 and weights (T, out_size) float32, in
    increasing input order; short columns are padded with weight 0.
    Uploaded once per device."""
    key = (in_size, out_size, device)
    taps = _RESIZE_TAPS.get(key)
    if taps is None:
        w = _resize_weights(in_size, out_size)
        nz = w != 0
        first = np.where(nz.any(0), nz.argmax(0), 0)
        T = max(int(nz.sum(0).max()), 1)
        idx = np.minimum(first[None, :] + np.arange(T)[:, None], in_size - 1)
        wts = np.take_along_axis(w, idx, axis=0)
        # A tap clamped onto the last input row is a repeat: weight 0.
        wts = np.where(first[None, :] + np.arange(T)[:, None] < in_size, wts, 0.0).astype(np.float32)
        taps = (torch.from_numpy(idx.astype(np.int64)).to(device), torch.from_numpy(wts).to(device))
        _RESIZE_TAPS[key] = taps
    return taps


def resize_linear(image: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 image -> `shape` (h, w) float32, the function of
    `jax.image.resize(image, shape, method="linear")` (antialiased).

    The reference contracts the image with two weight matrices. Each output
    sample has only a few nonzero weights, so this sums those taps instead,
    rows first, then columns, in a fixed order: the same bits on the CPU and
    on the card, where a matrix product's summation order is the library's."""
    out = image
    for dim, size in enumerate(shape):
        if size == out.shape[dim]:
            continue
        idx, wts = _resize_taps(out.shape[dim], size, image.device)
        acc = None
        for t in range(idx.shape[0]):
            w = wts[t][:, None] if dim == 0 else wts[t][None, :]
            term = out.index_select(dim, idx[t]) * w
            acc = term if acc is None else acc + term
        out = acc
    return out
