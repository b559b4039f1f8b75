"""Edge-case inputs of the PyTorch port's kernels (FAST, patches, Hamming and
the window gather), made with numpy from fixed seeds. Checks import it from
the repo's root; the port itself never does.

One definition serves three checks: the plain versions against the JAX
package on the CPU (tests/test_torch_kernels.py and
tests/test_torch_kernel_variants.py), and each kernel against its plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py phase 3).
Each case starts with its label; the arrays are numpy, so every check hands
the same bits to the version it runs.
"""

from __future__ import annotations

import numpy as np

# Train indices on both sides of every likely tile, warp and block boundary
# of a train axis split into 8-wide tiles, 4 ways, at Kt = 512.
TIE_PAIRS = ((0, 511), (15, 16), (63, 64), (127, 128), (255, 256))


def _words(rng, n: int, words: int) -> np.ndarray:
    return rng.integers(0, 2**32, (n, words), dtype=np.uint32)


def _near(rng, d: np.ndarray, n: int, flips: int) -> np.ndarray:
    """n copies of the packed descriptor `d` with `flips` random bits flipped each."""
    out = np.repeat(d[None], n, axis=0)
    nbits = 32 * d.shape[0]
    for row in out:
        for b in rng.choice(nbits, flips, replace=False):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def tie_trains(rng, kq: int, kt: int, words: int, invalid_first: bool):
    """Queries whose nearest trains are two identical copies at the indices of
    one pair of TIE_PAIRS (a pair per query group). With `invalid_first`, the
    lower copy of every pair is invalid, so the higher one must win. Every
    other train is random (about half its bits away)."""
    t = _words(rng, kt, words)
    v = np.ones(kt, bool)
    pairs = [p for p in TIE_PAIRS if p[1] < kt]
    if not pairs:  # a train axis too short for any pair: queries near train 0
        return _near(rng, t[0], kq, 6), t, v
    q = np.empty((kq, words), np.uint32)
    for i, j in pairs:
        t[i] = t[j] = _words(rng, 1, words)[0]
        if invalid_first:
            v[i] = False
    for r in range(kq):
        _, j = pairs[r % len(pairs)]
        q[r] = _near(rng, t[j], 1, 4 + r % 5)[0]
    return q, t, v


def hamming_cases() -> list[tuple[str, tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """(label, (queries (Kq, words) uint32, trains (Kt, words) uint32,
    validity (Kt,) bool)) for ties at tile, warp and block boundaries, all
    distances equal, the only valid train last, and Kt of 1, 511 and 513 with
    ragged Kq, at 8 and 16 words."""
    cases = []
    for words in (8, 16):
        rng = np.random.default_rng(100 + words)
        for invalid_first in (False, True):
            cases.append((f"ties at boundaries words={words} lower copy invalid={invalid_first}",
                          tie_trains(rng, 128, 512, words, invalid_first)))
        same = np.repeat(_words(rng, 1, words), 512, axis=0)
        v = rng.random(512) >= 0.5
        cases.append((f"all distances equal words={words}", (_words(rng, 128, words), same, v)))
        cases.append((f"all distances zero words={words}", (same[:128].copy(), same, np.ones(512, bool))))
        last = np.zeros(512, bool)
        last[-1] = True
        cases.append((f"only the last train valid words={words}", (_words(rng, 128, words), _words(rng, 512, words),
                                                                   last)))
        for kq, kt in ((77, 1), (100, 511), (130, 513)):
            q, t, v = tie_trains(rng, kq, kt, words, invalid_first=False)
            v &= rng.random(kt) >= 0.2
            v[TIE_PAIRS[1][1] if kt > 16 else 0] = True
            cases.append((f"Kq={kq} Kt={kt} words={words}", (q, t, v)))
    return cases


def _corner_image(rng, shape) -> np.ndarray:
    """Random rectangles plus noise: a corner-rich uint8 image."""
    img = np.full(shape, 120.0)
    for _ in range(max(4, shape[0] * shape[1] // 200)):
        y, x = rng.integers(0, max(1, shape[0] - 2)), rng.integers(0, max(1, shape[1] - 2))
        h, w = rng.integers(2, 20, 2)
        img[y : y + h, x : x + w] = rng.uniform(10, 245)
    img += rng.normal(0, 3.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def fast_cases() -> list[tuple[str, np.ndarray]]:
    """(label, (H, W) uint8 or float32 image): ragged sizes smaller and larger
    than a tile, constant images, plateaus, a 0/255 checkerboard and a float32
    level with non-integer values."""
    rng = np.random.default_rng(200)
    cases = [(f"corners {h}x{w} u8", _corner_image(rng, (h, w))) for h, w in ((7, 5), (33, 70), (343, 457))]
    cases.append(("constant 0 40x56 u8", np.zeros((40, 56), np.uint8)))
    cases.append(("constant 128 40x56 u8", np.full((40, 56), 128, np.uint8)))
    blocks = rng.integers(0, 4, (6, 9)) * 60
    cases.append(("plateaus 48x72 u8", np.kron(blocks, np.ones((8, 8))).astype(np.uint8)))
    yy, xx = np.mgrid[:37, :61]
    cases.append(("checkerboard 0/255 37x61 u8", (((yy + xx) % 2) * 255).astype(np.uint8)))
    cases.append(("non-integer 50x77 f32", rng.uniform(0, 255, (50, 77)).astype(np.float32)))
    return cases


def at_offset(array: np.ndarray, offset: int, device=None):
    """`array` as a contiguous torch tensor that starts `offset` elements into
    its storage (a view), on `device`: a base that is not 16-byte aligned."""
    import torch

    src = torch.from_numpy(np.ascontiguousarray(array)).reshape(-1)
    flat = torch.zeros(src.numel() + offset, dtype=src.dtype, device=device)
    flat[offset:] = src.to(device)
    return flat[offset:].view(array.shape)


def _patch_keypoints(rng, K: int, H: int, W: int) -> np.ndarray:
    """K keypoints: clamped at each edge, far outside, negative and exactly on
    .5 (round half to even both ways) first, then uniform over the image and
    a 5-pixel margin."""
    special = np.array(
        [[20.5, 13.5], [0, H / 2], [W - 1, H / 2], [W / 2, 0], [W / 2, H - 1], [-1000, -1000],
         [W + 1000, H + 1000], [-7, 3], [3.5, H - 2.5], [W - 15.5, H - 16.5], [0.5, 1.5], [-0.5, 2.5],
         [W + 3, -4], [W / 2 + 0.49, H / 2 + 0.51]],
        np.float32,
    )
    kps = rng.uniform(-5, [W + 5, H + 5], (K, 2)).astype(np.float32)
    n = min(K, len(special))
    kps[:n] = special[:n]
    return kps


def patch_cases() -> list[tuple[str, np.ndarray, np.ndarray, int, int]]:
    """(label, planes (C, H, W) f16 or f32, keypoints (K, 2) f32, ps, offset)
    for the patch gather: widths odd or not a multiple of 4 (457, 71, 33),
    K from 1 to 513, C from 1 to 7, ps from 1 to 33 and equal to H or W,
    SIFT's float32 single plane at 31x31 (640x480 and a level), the
    first 14 keypoints of each case at the edges, outside and on .5. With
    `offset` 1 the planes are handed over as a view 1 element into its
    storage (`at_offset`)."""
    rng = np.random.default_rng(300)
    shapes = (  # (C, H, W, dtype, K, ps, offset)
        (1, 343, 457, np.float16, 513, 31, 0),
        (5, 343, 457, np.float32, 65, 27, 0),
        (1, 343, 457, np.float16, 63, 31, 1),
        (7, 40, 71, np.float32, 9, 27, 0),
        (2, 40, 71, np.float16, 63, 32, 0),
        (3, 40, 71, np.float32, 65, 31, 1),
        (5, 40, 71, np.float16, 1, 2, 0),
        (3, 36, 33, np.float32, 7, 33, 0),
        (1, 36, 33, np.float16, 9, 1, 1),
        (2, 20, 71, np.float32, 9, 20, 0),
        (7, 33, 40, np.float16, 3, 33, 0),
        (1, 31, 33, np.float32, 7, 31, 0),
        (3, 40, 71, np.float16, 9, 27, 1),
        (7, 343, 457, np.float32, 3, 32, 1),
        (1, 480, 640, np.float32, 512, 31, 0),  # SIFT: one float32 plane, 31x31
        (1, 343, 457, np.float32, 170, 31, 1),  # SIFT on a pyramid level
    )
    cases = []
    for C, H, W, dtype, K, ps, offset in shapes:
        planes = rng.uniform(0, 255, (C, H, W)).astype(dtype)
        label = (f"{np.dtype(dtype).name} C={C} {W}x{H} K={K} ps={ps}"
                 + (" (=H)" if ps == H else "") + (" (=W)" if ps == W else "")
                 + (f" view at +{offset}" if offset else ""))
        cases.append((label, planes, _patch_keypoints(rng, K, H, W), ps, offset))
    return cases


def window_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int, bool, int, int]]:
    """(label, image (H, W) f32, ys (K,) int32, xs (K,) int32, rows, shifted,
    block, offset) for the window gather: windows that leave the image on
    every side, past the probe's padding too; xs at every residue mod 4;
    widths not a multiple of 4; K not a multiple of `block`; and an image
    handed over 1 element into its storage (`at_offset`)."""
    rng = np.random.default_rng(400)
    cases = []
    img = rng.random((40, 50), dtype=np.float32)
    ys = np.array([-3, 0, 35, 39, 100], np.int32)
    xs = np.array([0, 45, -2, 20, 3], np.int32)
    for rows in (31, 32):
        for shifted in (False, True):
            for block in (8, 64):
                cases.append((f"leaving the image rows={rows} shifted={shifted} block={block}", img, ys, xs, rows,
                              shifted, block, 0))
    img = rng.random((48, 64), dtype=np.float32)
    xs = np.arange(-4, 36, dtype=np.int32)  # every residue mod 4, from left of the image to past its right
    ys = rng.integers(-40, 60, xs.shape).astype(np.int32)
    for rows, block in ((32, 8), (31, 64)):
        cases.append((f"xs at every residue mod 4 rows={rows} block={block}", img, ys, xs, rows, True, block, 0))
    for W in (61, 62, 63):
        img = rng.random((37, W), dtype=np.float32)
        ys = rng.integers(-5, 37, 24).astype(np.int32)
        xs = rng.integers(-3, W + 1, 24).astype(np.int32)
        for shifted in (False, True):
            cases.append((f"W={W} shifted={shifted}", img, ys, xs, 32, shifted, 8, 0))
    img = rng.random((30, 40), dtype=np.float32)
    ys = np.array([22, 30, 37, 38, 39, 100, 0, 5], np.int32)  # past the 8 padded rows at the bottom
    xs = np.array([8, 40, 41, 72, 73, 500, 39, 9], np.int32)  # past the 32 padded columns on the right
    for shifted in (False, True):
        cases.append((f"past the padding shifted={shifted}", img, ys, xs, 31, shifted, 8, 0))
    img = rng.random((64, 96), dtype=np.float32)
    for K, block in ((67, 64), (13, 8)):
        ys = rng.integers(0, 40, K).astype(np.int32)
        xs = rng.integers(0, 70, K).astype(np.int32)
        cases.append((f"K={K} block={block}", img, ys, xs, 32, False, block, 0))
    ys = rng.integers(-4, 60, 40).astype(np.int32)
    xs = rng.integers(-4, 90, 40).astype(np.int32)
    for shifted in (False, True):
        cases.append((f"image view at +1 shifted={shifted}", img, ys, xs, 32, shifted, 64, 1))
    return cases
