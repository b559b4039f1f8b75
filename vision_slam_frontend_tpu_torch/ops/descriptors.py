"""Descriptor-family registry (port of ops/descriptors.py): the
reference's extractor switch.

A family supplies an `extractor(image, threshold, max_keypoints, border,
blur_sigma, num_levels, scale_factor) -> (keypoints, scores, descriptors,
valid)`, its `distance` ("hamming") and its width in packed words. ORB,
BRISK, FREAK and AKAZE are registered; the JAX package's SIFT family (L2
matching) is not ported, and asking for it fails with the registry's menu.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from vision_slam_frontend_tpu_torch.ops.akaze import detect_and_describe_akaze
from vision_slam_frontend_tpu_torch.ops.brief import detect_and_describe
from vision_slam_frontend_tpu_torch.ops.brisk import detect_and_describe_brisk
from vision_slam_frontend_tpu_torch.ops.freak import detect_and_describe_freak


@dataclasses.dataclass(frozen=True)
class DescriptorFamily:
    name: str
    extractor: Callable
    distance: str = "hamming"
    words: int = 8


_REGISTRY: dict[str, DescriptorFamily] = {}


def register_family(
    name: str, extractor: Callable, distance: str = "hamming", words: int = 8
) -> DescriptorFamily:
    """Register a descriptor family under `name` (lowercase); latest wins."""
    if distance != "hamming":
        raise ValueError(f"unknown distance metric {distance!r} (the port matches hamming only)")
    fam = DescriptorFamily(name.lower(), extractor, distance, words)
    _REGISTRY[fam.name] = fam
    return fam


def get_family(name: str) -> DescriptorFamily:
    """Look up a registered family; unknown names fail with the menu."""
    fam = _REGISTRY.get(name.lower())
    if fam is None:
        raise ValueError(
            f"unknown descriptor family {name!r}; registered: {registered_families()}"
        )
    return fam


def registered_families() -> list[str]:
    return sorted(_REGISTRY)


# ORB family: FAST-9 corners + quantized-rotation steered BRIEF, 256 bits
# packed into 8 words.
register_family("orb", detect_and_describe, distance="hamming", words=8)
# BRISK family: concentric rings with per-ring smoothing, 512 bits.
register_family("brisk", detect_and_describe_brisk, distance="hamming", words=16)
# AKAZE family, the reference's default extractor: nonlinear scale space,
# Hessian-determinant detection, 486 MLDB bits padded to 512.
register_family("akaze", detect_and_describe_akaze, distance="hamming", words=16)
# FREAK family: retinal pattern, coarse-to-fine pairs, FAST detector; 512 bits.
register_family("freak", detect_and_describe_freak, distance="hamming", words=16)
