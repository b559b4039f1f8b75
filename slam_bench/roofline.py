"""The least time each hand-written kernel can take, frozen.

Published peaks of one NVIDIA H100 SXM (dense, 700 W): 3.35 TB/s of HBM3,
1,979 TOP/s int8 on the tensor cores, 132 SMs at a 1,980 MHz boost clock;
Hopper issues 64 min/max (FMNMX) and 128 float32 adds a clock per SM. Each
input byte is counted read once and each output byte written once; the
operations are those these shapes need. A bound is the larger of the bytes'
time and the operations' time, in ms. A share is bound over measured time:
it cannot pass 100% unless the counts are too high or the time leaves out
work.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
SMS = 132
SM_HZ = 1.98e9
FMNMX_PER_CLOCK_SM = 64
FADD_PER_CLOCK_SM = 128
# FAST-9 + NMS per pixel: 16 ring-centre subtractions; 128 arc min/max by
# doubling plus 32 for both polarities and the best start, two values per
# instruction (half2) on a uint8 image, whose differences are exact in fp16;
# 8 NMS maxima and 1 compare.
FAST_SUBS_PER_PIXEL = 16
FAST_ARC_MINMAX_PER_PIXEL = 128 + 32
FAST_NMS_PER_PIXEL = 9


def bound_ms(bytes_moved: float, op_seconds: float = 0.0) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, op_seconds) * 1e3


def fast_nms_ms(h: int, w: int, elem_bytes: int) -> float:
    """B1 over an (h, w) image of `elem_bytes` (1: uint8, 4: float32): the
    image read, two float32 maps written, and its min/max and subtractions
    at their issue rates (uint8: two values per min/max)."""
    per_op = 2 if elem_bytes == 1 else 1
    minmax = FAST_ARC_MINMAX_PER_PIXEL / per_op + FAST_NMS_PER_PIXEL
    ops_s = h * w * (minmax / FMNMX_PER_CLOCK_SM + FAST_SUBS_PER_PIXEL / FADD_PER_CLOCK_SM) / (SMS * SM_HZ)
    return bound_ms(h * w * (elem_bytes + 8), ops_s)


def covered_pixels(starts_xy: np.ndarray, size: int, h: int, w: int) -> int:
    """Distinct pixels of an (h, w) plane inside size x size squares at
    integer (x, y) starts."""
    mask = np.zeros((h, w), bool)
    for x, y in np.asarray(starts_xy, np.int64):
        mask[max(y, 0):max(y, 0) + size, max(x, 0):max(x, 0) + size] = True
    return int(mask.sum())


def patch_starts(kps: np.ndarray, ps: int, h: int, w: int) -> np.ndarray:
    """Where each keypoint's patch starts: clip(round(kp) - ps // 2, 0,
    dim - ps), rounding half to even."""
    r = ps // 2
    xs = np.clip(np.round(kps[:, 0]).astype(np.int64) - r, 0, w - ps)
    ys = np.clip(np.round(kps[:, 1]).astype(np.int64) - r, 0, h - ps)
    return np.stack([xs, ys], 1)


def extract_patches_ms(covered: int, channels: int, elem_bytes: int, k: int, ps: int) -> float:
    """B2: the covered plane pixels read, the keypoints read, k patches written."""
    return bound_ms(covered * channels * elem_bytes + k * 2 * 4 + k * channels * ps * ps * elem_bytes)


def hamming_top2_ms(kq: int, kt: int, words: int, n_valid: int) -> float:
    """B3/B4: descriptors and validity read, (index, d1, d2) written; the
    b1 products of the valid trains at the int8 tensor rate (the b1 rate is
    unpublished)."""
    n_bytes = (kq + kt) * words * 4 + kt + kq * 12
    return bound_ms(n_bytes, 2.0 * kq * n_valid * words * 32 / INT8_TENSOR_OPS_PER_S)


def share(ctx: dict, symbol: str, bound_per_keyframe) -> float | None:
    """100 x the summed bound of the slice's keyframes over the profiled
    time of the kernels whose name holds `symbol`; None when the slice is
    missing or its launch count is not the one the keyframes need (a trace
    that lacks a kernel is not read as 0)."""
    rec = ctx.get("slice")
    info = ctx.get("slice_info", {})
    if rec is None or not info.get("keyframes"):
        return None
    launches = [k for k in rec["kernels"] if symbol in k[0] and k[3] == "kernel"]
    total_bound, expected = 0.0, 0
    for kf in info["keyframes"]:
        if kf >= len(ctx["ref_results"]):
            return None
        b, n = bound_per_keyframe(ctx, ctx["ref_results"][kf])
        total_bound += b
        expected += n
    measured = sum(k[2] for k in launches) * 1e3
    if len(launches) != expected or measured <= 0:
        return None
    return 100.0 * total_bound / measured
