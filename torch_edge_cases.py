"""Edge-case inputs of the PyTorch port's FAST and Hamming kernels, made with
numpy from fixed seeds. Checks import it from the repo's root; the port
itself never does.

One definition serves three checks: the plain versions against the JAX
package on the CPU (tests/test_torch_kernels.py), and each kernel against its
plain version on the card (tests/test_torch_cuda.py and chip_smoke.py phase
3). Each case is (label, arrays); the arrays are numpy, so every check hands
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
