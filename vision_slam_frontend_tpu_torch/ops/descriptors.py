"""Descriptor-family registry (port of ops/descriptors.py): the
reference's extractor switch.

A family supplies an `extractor(image, threshold, max_keypoints, border,
blur_sigma, num_levels, scale_factor) -> (keypoints, scores, descriptors,
valid)`, its `distance` ("hamming": packed int32 words; "l2": float
vectors) and its width (packed words, or float dimensions for l2). ORB,
BRISK, AKAZE, SIFT and FREAK are registered, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from vision_slam_frontend_tpu_torch.ops.akaze import detect_and_describe_akaze
from vision_slam_frontend_tpu_torch.ops.brief import detect_and_describe
from vision_slam_frontend_tpu_torch.ops.brisk import detect_and_describe_brisk
from vision_slam_frontend_tpu_torch.ops.freak import detect_and_describe_freak
from vision_slam_frontend_tpu_torch.ops.sift import detect_and_describe_sift


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
    if distance not in ("hamming", "l2"):
        raise ValueError(f"unknown distance metric {distance!r} (hamming|l2)")
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
# SIFT-class float family: 128-d gradient histograms, L2 matching; `words`
# is the float dimensionality.
register_family("sift", detect_and_describe_sift, distance="l2", words=128)
# FREAK family: retinal pattern, coarse-to-fine pairs, FAST detector; 512 bits.
register_family("freak", detect_and_describe_freak, distance="hamming", words=16)


def descriptor_dtype(family: DescriptorFamily):
    """The window's descriptor dtype for `family`: float32 for l2 families,
    int32 words (the reference's uint32 bits) for hamming ones."""
    return torch.float32 if family.distance == "l2" else torch.int32
