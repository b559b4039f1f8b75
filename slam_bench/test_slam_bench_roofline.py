"""The frozen roofline arithmetic reproduces the bound column of the port's
kernel table (PERF.md, NVIDIA H100 80GB HBM3 at 700 W) at its shapes, and a
share reads nothing where the trace lacks a kernel."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import roofline


def test_b1_fast_nms_at_640x480_u8():
    assert roofline.fast_nms_ms(480, 640, 1) == pytest.approx(0.00178, abs=5e-6)
    assert roofline.fast_nms_ms(480, 640, 4) == pytest.approx(0.00325, abs=5e-6)
    assert roofline.fast_nms_ms(343, 457, 4) == pytest.approx(0.00166, abs=5e-6)


def test_b2_extract_patches_orb_k512():
    """The table's keypoints: FAST on the second frame of the synthetic
    sequence (threshold 12, K=512, border 19), the last ten replaced by
    corners, outside points and half-pixel positions."""
    from vision_slam_frontend_tpu_torch.io.synthetic import generate_sequence
    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect

    frames = list(generate_sequence(num_frames=2))
    img = torch.from_numpy(np.clip(frames[1].left, 0, 255).astype(np.uint8))
    kps, _, _ = fast_detect(img, threshold=12.0, max_keypoints=512, border=19)
    special = torch.tensor([[0.0, 0.0], [639.0, 479.0], [-7.0, 3.0], [700.0, 500.0], [100.5, 200.5],
                            [101.5, 33.5], [15.5, 15.5], [624.5, 464.5], [320.49, 240.51], [2.5, 477.5]])
    kps = torch.cat([kps[:502], special]).numpy()
    covered = roofline.covered_pixels(roofline.patch_starts(kps, 31, 480, 640), 31, 480, 640)
    assert roofline.extract_patches_ms(covered, 1, 2, 512, 31) == pytest.approx(0.00034, abs=5e-6)


def test_b3_hamming_top2_window_5120x512_8_words():
    rng = np.random.default_rng(0)
    rng.integers(0, 2**32, (5120, 8), dtype=np.uint32)
    rng.integers(0, 2**32, (512, 8), dtype=np.uint32)
    n_valid = int((rng.random(512) >= 0.3).sum())
    assert roofline.hamming_top2_ms(5120, 512, 8, n_valid) == pytest.approx(0.00047, abs=5e-6)


def test_a_share_of_a_bound_met_exactly_is_100_and_a_missing_kernel_reads_nothing():
    def bound(ctx, r):
        return 0.002, 2

    kernels = [("fast_nms_kernel<1>", 0.0, 1e-6, "kernel"), ("fast_nms_kernel<1>", 1.0, 1e-6, "kernel")]
    ctx = dict(slice=dict(kernels=kernels), slice_info=dict(keyframes=[0]), ref_results=[{}])
    assert roofline.share(ctx, "fast_nms_kernel", bound) == pytest.approx(100.0)
    ctx["slice"]["kernels"] = kernels[:1]
    assert roofline.share(ctx, "fast_nms_kernel", bound) is None
    ctx["slice"] = None
    assert roofline.share(ctx, "fast_nms_kernel", bound) is None
