"""The port's CUDA kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode) and XLA paths, the wrappers'
dispatch and checks. The window-gather kernel's are in
tests/test_torch_kernel_variants.py. Each kernel against its plain version on the card is in
tests/test_torch_cuda.py.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every comparison is exact: the kernels' outputs are integers (FAST scores,
Hamming distances, indices) or copies (patches).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from vision_slam_frontend_tpu.ops import brief as jbrief  # noqa: E402
from vision_slam_frontend_tpu.ops import fast as jfast  # noqa: E402
from vision_slam_frontend_tpu.ops import hamming as jhamming  # noqa: E402
from vision_slam_frontend_tpu.ops import pallas_kernels as pk  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import _build  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
import torch_edge_cases as edge_cases  # noqa: E402

HAMMING_CASES = edge_cases.hamming_cases()
FAST_CASES = edge_cases.fast_cases()


def _image(seed, shape=(96, 128)):
    """A corner-rich uint8 image: random rectangles plus noise."""
    rng = np.random.default_rng(seed)
    img = np.full(shape, 120.0)
    for _ in range(60):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(3, 20, 2)
        img[y : y + h, x : x + w] = rng.uniform(10, 245)
    img += rng.normal(0, 3.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _random_words(rng, n, words):
    return rng.integers(0, 2**32, (n, words), dtype=np.uint32)


def _t32(words_u32):
    return torch.from_numpy(words_u32.view(np.int32))


def _xla_nms(score):
    """The reference's strict 8-neighbour NMS (ops/fast.fast_detect)."""
    H, W = score.shape
    padded = jnp.pad(score, 1, constant_values=-jnp.inf)
    neigh = jnp.stack([
        padded[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
    ]).max(0)
    return jnp.where(score > neigh, score, -jnp.inf)


# ---------------------------------------------------------------------------
# B1: FAST score + NMS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (96, 128)), (1, (40, 56)), (2, (33, 70))])
def test_fast_plain_matches_pallas_interpret(seed, shape):
    img = _image(seed, shape)
    raw_j, sup_j = pk.fast_scores_nms(jnp.asarray(img, jnp.float32), interpret=True)
    raw, sup = ck.fast_scores_nms(torch.from_numpy(img))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_j))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))


def test_fast_plain_matches_xla_path_on_interior():
    """The XLA path edge-pads and forces the 3-pixel border to -inf; the
    kernel zero-pads. Raw scores agree where the ring stays inside the image
    (>= 3 px from the edge), suppressed ones where the NMS also does (>= 4)."""
    img = _image(3)
    score_j = jfast.fast_scores(jnp.asarray(img))
    raw, sup = ck.fast_scores_nms(torch.from_numpy(img))
    np.testing.assert_array_equal(raw.numpy()[3:-3, 3:-3], np.asarray(score_j)[3:-3, 3:-3])
    np.testing.assert_array_equal(sup.numpy()[4:-4, 4:-4], np.asarray(_xla_nms(score_j))[4:-4, 4:-4])


@pytest.mark.parametrize("case", range(len(FAST_CASES)), ids=[c[0] for c in FAST_CASES])
def test_fast_plain_matches_pallas_interpret_on_edge_cases(case):
    """Ragged sizes smaller and larger than a CUDA tile, constant images,
    plateaus, a 0/255 checkerboard and a non-integer float32 level."""
    _, img = FAST_CASES[case]
    raw_j, sup_j = pk.fast_scores_nms(jnp.asarray(img, jnp.float32), interpret=True)
    raw, sup = ck.fast_scores_nms(torch.from_numpy(img))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_j))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))


def test_fast_wrapper_checks_input():
    with pytest.raises(ValueError, match="uint8 or float32"):
        ck.fast_scores_nms(torch.zeros((8, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="uint8 or float32"):
        ck.fast_scores_nms(torch.zeros((2, 8, 8), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# B2: patch extraction
# ---------------------------------------------------------------------------


def _patch_keypoints(seed, H, W, K=64):
    """Random keypoints plus clamped corners, out-of-image points and exact
    .5 coordinates (round half to even)."""
    rng = np.random.default_rng(seed)
    kps = rng.uniform(-5, [W + 5, H + 5], (K, 2)).astype(np.float32)
    special = np.array(
        [[0, 0], [W - 1, H - 1], [-7, 3], [W + 40, H + 40], [20.5, 30.5], [21.5, 31.5],
         [15.5, 15.5], [W - 15.5, H - 16.5], [40.49, 40.51], [2.5, H - 2.5]],
        np.float32,
    )
    kps[: len(special)] = special
    return kps


@pytest.mark.parametrize("channels,dtype,K", [(1, np.float16, 64), (2, np.float32, 16)])
def test_patches_plain_matches_pallas_interpret(channels, dtype, K):
    rng = np.random.default_rng(4)
    planes = rng.uniform(0, 255, (channels, 96, 128)).astype(dtype)
    kps = _patch_keypoints(5, 96, 128, K)
    ref = pk.extract_patches_vmem(
        jnp.asarray(planes, jnp.float32), jnp.asarray(kps), block=16, interpret=True
    )
    out = ck.extract_patches(torch.from_numpy(planes), torch.from_numpy(kps), 31)
    assert out.dtype == torch.from_numpy(planes).dtype and out.shape == (K, channels, 961)
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), np.asarray(ref))


def test_patches_plain_matches_xla_gather():
    rng = np.random.default_rng(6)
    image = rng.uniform(0, 255, (96, 128)).astype(np.float16)
    kps = _patch_keypoints(7, 96, 128)
    ref = jbrief.extract_patches(jnp.asarray(image), jnp.asarray(kps))  # (K, 961)
    out = ck.extract_patches(torch.from_numpy(image)[None], torch.from_numpy(kps), 31)[:, 0]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_patches_other_patch_size():
    rng = np.random.default_rng(8)
    planes = rng.uniform(0, 255, (1, 40, 50)).astype(np.float32)
    kps = _patch_keypoints(9, 40, 50, K=16)
    out = ck.extract_patches(torch.from_numpy(planes), torch.from_numpy(kps), 27).numpy()
    for k, (x, y) in enumerate(kps):
        sx = min(max(int(np.rint(x)) - 13, 0), 50 - 27)
        sy = min(max(int(np.rint(y)) - 13, 0), 40 - 27)
        np.testing.assert_array_equal(out[k, 0], planes[0, sy : sy + 27, sx : sx + 27].ravel())


def test_patches_wrapper_checks_input():
    planes = torch.zeros((1, 40, 40), dtype=torch.float16)
    with pytest.raises(ValueError, match="keypoints"):
        ck.extract_patches(planes, torch.zeros((4, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="does not fit"):
        ck.extract_patches(planes, torch.zeros((4, 2)), 41)
    with pytest.raises(ValueError, match="planes"):
        ck.extract_patches(torch.zeros((1, 40, 40), dtype=torch.uint8), torch.zeros((4, 2)))


# ---------------------------------------------------------------------------
# B3: Hamming kNN(2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kq,kt,words,invalid", [(256, 512, 8, 0.0), (128, 1024, 8, 0.3), (256, 512, 16, 0.2)]
)
def test_hamming_plain_matches_mxu_interpret(kq, kt, words, invalid):
    """Every row has a valid train here, so the MXU kernel's 3e9 sentinel
    never shows and all three outputs compare exactly."""
    rng = np.random.default_rng(kq + kt + words)
    q, t = _random_words(rng, kq, words), _random_words(rng, kt, words)
    v = rng.random(kt) >= invalid
    idx_j, d1_j, d2_j = pk.hamming_top2_mxu(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v), interpret=True)
    idx, d1, d2 = ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d1_j))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2_j))


@pytest.mark.parametrize(
    "kq,kt,words,invalid",
    [(512, 512, 8, 0.3), (77, 300, 8, 0.5), (64, 200, 16, 0.0), (32, 40, 8, 1.0), (16, 1, 8, 0.0)],
)
def test_hamming_plain_matches_xla_knn2(kq, kt, words, invalid):
    """Against the reference's XLA path, 1e9 sentinels included (the
    all-invalid and single-train cases), at ragged sizes."""
    rng = np.random.default_rng(kq * 7 + kt)
    q, t = _random_words(rng, kq, words), _random_words(rng, kt, words)
    v = rng.random(kt) >= invalid
    dist = jhamming.hamming_distance_matrix(jbrief.unpack_bits(jnp.asarray(q)), jbrief.unpack_bits(jnp.asarray(t)))
    idx_j, d1_j, d2_j = jhamming.knn2_match(dist, jnp.asarray(v))
    idx, d1, d2 = ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d1_j))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2_j))


@pytest.mark.parametrize("kq,kt,words,invalid", [(128, 256, 8, 0.3), (256, 128, 16, 0.5), (128, 128, 8, 1.0)])
def test_hamming_plain_matches_xor_popcount_interpret(kq, kt, words, invalid):
    """B4 (`hamming_top2`, XOR + popcount) in interpret mode: its sentinel
    1 << 20 is the port's 1e9, and idx is compared where d1 is a real
    distance (<= the bit width); the all-invalid case has none."""
    rng = np.random.default_rng(kq + 3 * kt + words)
    q, t = _random_words(rng, kq, words), _random_words(rng, kt, words)
    v = rng.random(kt) >= invalid
    idx_j, d1_j, d2_j = (np.asarray(a) for a in pk.hamming_top2(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                                                                  interpret=True))
    idx, d1, d2 = (a.numpy() for a in ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v)))
    nbits = 32 * words
    big = float(1 << 20)
    np.testing.assert_array_equal(d1, np.where(d1_j == big, 1e9, d1_j))
    np.testing.assert_array_equal(d2, np.where(d2_j == big, 1e9, d2_j))
    real = d1_j <= nbits
    np.testing.assert_array_equal(idx[real], idx_j[real])
    assert real.mean() == (0.0 if invalid == 1.0 else 1.0)


@pytest.mark.parametrize("case", range(len(HAMMING_CASES)), ids=[c[0] for c in HAMMING_CASES])
def test_hamming_plain_matches_references_on_edge_cases(case):
    """Tie-heavy and ragged cases against the XLA knn2_match, and against
    hamming_top2_mxu in interpret mode where its shapes allow (Kq % 128,
    Kt % 512). The MXU kernel adds 1e9 to an invalid train's distance (3e9
    where none is left), so any value of it >= 1e9 is the port's 1e9."""
    _, (q, t, v) = HAMMING_CASES[case]
    idx, d1, d2 = (a.numpy() for a in ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v)))
    dist = jhamming.hamming_distance_matrix(jbrief.unpack_bits(jnp.asarray(q)), jbrief.unpack_bits(jnp.asarray(t)))
    for ref, out in zip(jhamming.knn2_match(dist, jnp.asarray(v)), (idx, d1, d2)):
        np.testing.assert_array_equal(out, np.asarray(ref))
    if q.shape[0] % 128 == 0 and t.shape[0] % 512 == 0:
        idx_j, d1_j, d2_j = (np.asarray(a) for a in pk.hamming_top2_mxu(jnp.asarray(q), jnp.asarray(t),
                                                                          jnp.asarray(v), interpret=True))
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(d1, np.where(d1_j >= 1e9, 1e9, d1_j))
        np.testing.assert_array_equal(d2, np.where(d2_j >= 1e9, 1e9, d2_j))


def test_hamming_edge_cases_pin_the_tie_rule():
    """The cases hold what they claim: the lowest valid copy of a tied pair
    wins, d1 == d2 on ties, the last train wins when it alone is valid."""
    by_label = dict(HAMMING_CASES)
    for words in (8, 16):
        for invalid_first in (False, True):
            q, t, v = by_label[f"ties at boundaries words={words} lower copy invalid={invalid_first}"]
            idx, d1, d2 = (a.numpy() for a in ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v)))
            pairs = edge_cases.TIE_PAIRS
            want = np.array([pairs[r % len(pairs)][1 if invalid_first else 0] for r in range(len(q))])
            np.testing.assert_array_equal(idx, want)
            assert (d1 <= 8).all() and (d2 == d1).all() != invalid_first
        q, t, v = by_label[f"only the last train valid words={words}"]
        idx, d1, d2 = (a.numpy() for a in ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v)))
        assert (idx == len(t) - 1).all() and (d1 < 1e9).all() and (d2 == 1e9).all()
        q, t, v = by_label[f"all distances zero words={words}"]
        idx, d1, d2 = (a.numpy() for a in ck.hamming_top2(_t32(q), _t32(t), torch.from_numpy(v)))
        assert (idx == 0).all() and (d1 == 0).all() and (d2 == 0).all()


def test_hamming_ties_take_lowest_index():
    q = np.zeros((1, 8), np.uint32)
    t = np.zeros((5, 8), np.uint32)
    t[0, 0] = 1  # distance 1; rows 1..4 are at distance 0
    idx, d1, d2 = ck.hamming_top2(_t32(q), _t32(t), torch.tensor([True, False, True, True, True]))
    assert (idx.item(), d1.item(), d2.item()) == (2, 0.0, 0.0)


def test_hamming_wrapper_checks_input():
    q = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="8 or 16"):
        ck.hamming_top2(q[:, :4], q[:, :4], torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="int32"):
        ck.hamming_top2(q.long(), q.long(), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="valid_t"):
        ck.hamming_top2(q, q, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="empty"):
        ck.hamming_top2(q, q[:0], torch.ones(0, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Dispatch, launch counts, build
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions_without_counting():
    ck.reset_launch_counts()
    img = torch.from_numpy(_image(10, (40, 40)))
    ck.fast_scores_nms(img)
    ck.extract_patches(img.float()[None], torch.zeros((2, 2)), 31)
    ck.hamming_top2(torch.zeros((2, 8), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32),
                    torch.ones(3, dtype=torch.bool))
    ck.patch_windows(img.float(), torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    assert ck.LAUNCHES == {"fast_scores_nms": 0, "extract_patches": 0, "hamming_top2": 0, "patch_windows": 0}


def test_build_needs_nvcc_and_names_the_library_by_source_hash(tmp_path, monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("libvsf_kernels_") and path == _build.library_path()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
