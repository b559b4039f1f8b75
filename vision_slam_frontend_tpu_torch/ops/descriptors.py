"""Descriptor-family registry (port of ops/descriptors.py), ORB only.

A family supplies an `extractor(image, threshold, max_keypoints, border,
blur_sigma, num_levels) -> (keypoints, scores, descriptors, valid)`, its
`distance` ("hamming") and its width in packed words. The BRISK, FREAK,
AKAZE and SIFT families of the JAX package are not ported yet; asking for
one fails with the registry's menu.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from vision_slam_frontend_tpu_torch.ops.brief import detect_and_describe


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
