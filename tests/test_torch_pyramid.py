"""The port's image pyramid against the JAX package's, on the CPU: the
linear resize, the FAST kernel's plain version on float32 levels, and the
ORB extractor over 3 levels.

Tolerances: resize 1e-4 absolute (the reference's compiled CPU program
rounds its weights and sums in its own order); FAST scores on float32
levels exact (the same f32 differences, mins and maxes); the 3-level ORB
keypoints at least 99% equal (within 1e-4 px), validity exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.ops import brief as jbrief  # noqa: E402
from vision_slam_frontend_tpu.ops import fast as jfast  # noqa: E402
from vision_slam_frontend_tpu.ops import pallas_kernels as pk  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import brief as tbrief  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import fast as tfast  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.image import resize_linear  # noqa: E402


@pytest.fixture(scope="module")
def frame():
    f = next(iter(generate_sequence(num_frames=1, rig=SyntheticRig())))
    return np.clip(f.left, 0, 255).astype(np.uint8)  # 640x480


@pytest.mark.parametrize("shape", [(343, 457), (245, 327)])
def test_resize_linear_matches_jax(frame, shape):
    img = frame.astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, method="linear"))
    out = resize_linear(torch.from_numpy(img), shape)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_resize_linear_random_and_upscale():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    for shape in ((343, 457), (245, 327), (480, 457)):
        ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, method="linear"))
        np.testing.assert_allclose(resize_linear(torch.from_numpy(img), shape).numpy(), ref, rtol=0, atol=1e-4)
    same = resize_linear(torch.from_numpy(img), (480, 640))
    assert torch.equal(same, torch.from_numpy(img))


def test_pyramid_levels_sizes_and_budgets(frame):
    levels = tbrief.pyramid_levels(torch.from_numpy(frame), 3, 1.4, 19, 512)
    assert [tuple(img.shape) for img, _, _ in levels] == [(480, 640), (343, 457), (245, 327)]
    assert [b for _, b, _ in levels] == [170, 170, 172]
    assert [s for _, _, s in levels] == [1.0, 1.4, 1.4 * 1.4]
    assert levels[0][0].dtype == torch.uint8 and levels[1][0].dtype == torch.float32
    tiny = tbrief.pyramid_levels(torch.zeros((60, 70), dtype=torch.uint8), 3, 1.4, 19, 64)
    assert [tuple(img.shape) for img, _, _ in tiny] == [(60, 70), (46, 50), (46, 46)]


@pytest.mark.parametrize("shape", [(343, 457), (53, 69)])
def test_fast_plain_on_float32_matches_pallas_interpret(frame, shape):
    """B1's plain version on a resized (non-integer) level against the Pallas
    kernel in interpret mode, ragged sizes included: exact."""
    level = resize_linear(torch.from_numpy(frame.astype(np.float32)), shape)
    raw_j, sup_j = pk.fast_scores_nms(jnp.asarray(level.numpy()), interpret=True)
    raw, sup = ck.fast_scores_nms(level)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_j))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(sup_j))
    assert np.unique(raw.numpy()).size > 100  # non-integer scores


def test_fast_detect_on_float32_matches_jax(frame):
    level = resize_linear(torch.from_numpy(frame.astype(np.float32)), (245, 327))
    kps_j, scores_j, valid_j = jfast.fast_detect(jnp.asarray(level.numpy()), threshold=12.0,
                                                 max_keypoints=128, border=19)
    kps, scores, valid = tfast.fast_detect(level, threshold=12.0, max_keypoints=128, border=19)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(scores_j))
    np.testing.assert_allclose(kps.numpy(), np.asarray(kps_j), rtol=0, atol=1e-5)
    assert valid.sum() > 64


def test_orb_three_levels_matches_jax(frame):
    ref = [np.asarray(a) for a in jbrief.detect_and_describe(
        jnp.asarray(frame), threshold=12.0, max_keypoints=512, border=19, num_levels=3)]
    out = [a.numpy() for a in tbrief.detect_and_describe(
        torch.from_numpy(frame), threshold=torch.tensor(12.0), max_keypoints=512, border=19, num_levels=3)]
    kps, scores, desc, valid = out
    r_kps, r_scores, r_desc, r_valid = ref
    np.testing.assert_array_equal(valid, r_valid)
    same = np.abs(kps - r_kps).max(1) <= 1e-4
    assert same.mean() >= 0.99
    assert (desc.view(np.uint32) == r_desc).all(1).mean() >= 0.99
    assert valid.sum() > 300 and kps[valid].max() > 500  # level 1 and 2 keypoints at level-0 scale
