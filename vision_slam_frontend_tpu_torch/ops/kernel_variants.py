"""The window-gather kernel's five cases at the TPU probe's shapes (port of
probe_kernel_variants.py's entry point).

The TPU probe bisected which Pallas constructs its toolchain accepted for a
VMEM patch gather. Its function is one gather (ops/cuda_kernels.
patch_windows): 32-column windows at a per-keypoint row start, reading
columns 0..31 (E1, E2, E5) or xs[k]..xs[k]+31 (E3 by a one-hot product,
E4 by a lane roll: two TPU devices for one shifted read, the same case of
the CUDA kernel here). Each case runs on the card, is held against the plain
version (exact), and is timed on the device (utils/cuda_timing.device_ms)
beside it and beside one PyTorch advanced-indexing gather:

    python -m vision_slam_frontend_tpu_torch.ops.kernel_variants

It raises if a case disagrees. `--device cpu` runs the plain version alone,
with no times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck
from vision_slam_frontend_tpu_torch.utils.cuda_timing import call_ms, device_ms

# (name, rows, shifted, keypoints per block), in the probe's order.
CASES = (
    ("E1 dyn-sublane, 32 rows, blk64", 32, False, 64),
    ("E2 dyn-sublane, 31 rows, blk64", 31, False, 64),
    ("E3 shifted read (TPU: one-hot product), blk64", 32, True, 64),
    ("E4 shifted read (TPU: roll), blk64", 32, True, 64),
    ("E5 dyn-sublane, 32 rows, blk8", 32, False, 8),
)
PROBE_SHAPE = (480, 640, 8192)  # H, W, K


def probe_inputs(H: int, W: int, K: int, device, seed: int = 0):
    """The probe's inputs: a uniform [0, 255) f32 image and the row and
    column starts of 31x31 windows around uniform keypoints, from
    numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    kps = rng.uniform([20, 20], [W - 20, H - 20], (K, 2)).astype(np.float32)
    ys = np.clip(np.rint(kps[:, 1]).astype(np.int32) - 15, 0, H - 31)
    xs = np.clip(np.rint(kps[:, 0]).astype(np.int32) - 15, 0, W - 31)
    to = lambda a: torch.from_numpy(a).to(device)
    return to(img), to(ys), to(xs)


def index_gather(padded: torch.Tensor, rows_idx: torch.Tensor, cols_idx: torch.Tensor) -> torch.Tensor:
    """One PyTorch advanced-indexing gather of the windows from the padded
    image: the library call beside the kernel (never used by the port)."""
    return padded[rows_idx, cols_idx]


def gather_indices(ys: torch.Tensor, xs: torch.Tensor, rows: int, shifted: bool):
    """Broadcast row and column indices of the windows into the image padded
    by (0, 8) rows and (0, 32) columns."""
    dev = ys.device
    r = ys.long()[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    c0 = xs.long() if shifted else torch.zeros_like(xs, dtype=torch.long)
    c = c0[:, None, None] + torch.arange(ck.WINDOW_COLS, device=dev)[None, None, :]
    return r, c


def run_cases(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> list[dict]:
    """Each case: the kernel (on a CUDA device) against the plain version,
    exactly, then, on the card, the device times of the kernel, the plain
    version and one index gather (utils/cuda_timing.device_ms; plain, kernel,
    kernel, plain: each the mean of two), and the kernel's cost per call
    (call_ms). Raises on the first disagreement."""
    on_card = img.device.type == "cuda"
    padded = torch.nn.functional.pad(img, (0, ck.WINDOW_COLS, 0, 8))
    results = []
    for name, rows, shifted, block in CASES:
        out = ck.patch_windows(img, ys, xs, rows, shifted, block)
        ref = ck.patch_windows_plain(img, ys, xs, rows, shifted, block)
        if on_card:
            torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.equal(out, ref):
            bad = int((out != ref).sum()) if out.shape == ref.shape else out.numel()
            raise AssertionError(f"patch_windows case {name!r}: {bad} of {ref.numel()} values differ "
                                 "from the plain version")
        row = {"name": name, "max_abs_err": 0.0, "ms": None, "call_ms": None, "plain_ms": None, "library_ms": None}
        if on_card:
            r_idx, c_idx = gather_indices(ys, xs, rows, shifted)
            if not torch.equal(index_gather(padded, r_idx, c_idx), ref):
                raise AssertionError(f"case {name!r}: the index gather disagrees with the plain version")
            kernel = lambda: ck.patch_windows(img, ys, xs, rows, shifted, block)
            plain = lambda: ck.patch_windows_plain(img, ys, xs, rows, shifted, block)
            p1, k1, k2, p2 = device_ms(plain), device_ms(kernel), device_ms(kernel), device_ms(plain)
            row.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, call_ms=call_ms(kernel),
                       library_ms=device_ms(lambda: index_gather(padded, r_idx, c_idx)))
        results.append(row)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to run the plain version alone)")
    H, W, K = PROBE_SHAPE
    img, ys, xs = probe_inputs(H, W, K, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain version only)"
    print(f"patch_windows at H={H} W={W} K={K} on {where}", flush=True)
    for r in run_cases(img, ys, xs):
        times = ("" if r["ms"] is None else
                 f" device ms: kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, index gather "
                 f"{r['library_ms']:.4f}; kernel call {r['call_ms']:.4f} ms")
        print(f"{r['name']:46s} parity=OK (max_abs_err {r['max_abs_err']}){times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
