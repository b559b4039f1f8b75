"""Whole-image primitives: separable Gaussian blur (port of ops/image.py).

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
