"""The port's ops, geometry and configuration against the JAX package's CPU
path, on the same numpy inputs.

Tolerances and why:
  - FAST valid flags, integer positions and scores, descriptor words, match
    indices, distances and masks: exact (integer arithmetic on both sides).
  - Sub-pixel keypoints: 1e-5 px (the same float32 quadratic fit).
  - Gaussian blur: 1e-4 absolute (the same float32 taps; sums may round
    differently).
  - Orientation: 1e-4 rad. Descriptor words: exact for every valid keypoint
    whose angle lies more than 1e-3 rad from a rotation-bin edge, and for at
    least 99% of all valid keypoints (an angle within rounding of an edge may
    fall in the other bin).
  - undistort_points 1e-3 px; epipolar_residual 1e-4 relative; rotation
    matrices 1e-6; the configuration's derived matrices 1e-6 relative to
    their largest entry; camera-matrix inverses exact.
  - triangulate_points: within 1e-5 relative of an independent float64
    least-squares solve, and no farther from the reference than the
    reference's own float32 error plus 1e-4 relative; median difference
    below 1e-4. The port solves in float64; the reference's float32 normal
    equations are off by up to ~2e-3 relative at 3-40 m (they square the
    system's condition number), so no tighter bound against it holds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.geometry import camera as jcam  # noqa: E402
from vision_slam_frontend_tpu.geometry import rotation as jrot  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.ops import brief as jbrief  # noqa: E402
from vision_slam_frontend_tpu.ops import fast as jfast  # noqa: E402
from vision_slam_frontend_tpu.ops import hamming as jhamming  # noqa: E402
from vision_slam_frontend_tpu.ops import image as jimage  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.geometry import camera as tcam  # noqa: E402
from vision_slam_frontend_tpu_torch.geometry import rotation as trot  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import brief as tbrief  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import descriptors as tdesc  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import fast as tfast  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import hamming as thamming  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import image as timage  # noqa: E402


@pytest.fixture(scope="module")
def frame():
    """A rendered 640x480 synthetic stereo pair as uint8."""
    f = next(generate_sequence(num_frames=1, rig=SyntheticRig()))
    return np.clip(f.left, 0, 255).astype(np.uint8), np.clip(f.right, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def detections(frame):
    """Reference FAST detections and blur of the left frame."""
    img = frame[0]
    kps, scores, valid = jfast.fast_detect(jnp.asarray(img), threshold=12.0, max_keypoints=512, border=19)
    blurred = jimage.gaussian_blur(jnp.asarray(img, jnp.float32), sigma=2.0)
    return np.array(kps), np.array(scores), np.array(valid), np.array(blurred)


# ---------------------------------------------------------------------------
# FAST detection and blur
# ---------------------------------------------------------------------------


def _check_detect(img, threshold, K, border):
    kps_j, scores_j, valid_j = (np.asarray(a) for a in jfast.fast_detect(
        jnp.asarray(img), threshold=threshold, max_keypoints=K, border=border))
    kps, scores, valid = (a.numpy() for a in tfast.fast_detect(
        torch.from_numpy(img), threshold=threshold, max_keypoints=K, border=border))
    np.testing.assert_array_equal(valid, valid_j)
    np.testing.assert_array_equal(scores, scores_j)
    np.testing.assert_array_equal(np.rint(kps), np.rint(kps_j))
    np.testing.assert_allclose(kps, kps_j, rtol=0, atol=1e-5)
    return valid_j.sum()


def test_fast_detect_full_frame(frame):
    assert _check_detect(frame[0], 12.0, 512, 19) > 100


def test_fast_detect_ties_at_the_top_k_cut():
    """A tiled pattern gives many equal integer scores: the K-th cut falls
    inside a tie, which must break by lower flat index as lax.top_k does."""
    rng = np.random.default_rng(0)
    img = np.tile(rng.integers(0, 256, (8, 8)), (12, 16)).astype(np.uint8)
    n_valid = _check_detect(img, 5.0, 64, 8)
    assert n_valid == 64


def test_fast_scores_interior(frame):
    img = frame[1][:96, :128]
    ref = np.asarray(jfast.fast_scores(jnp.asarray(img)))
    out = tfast.fast_scores(torch.from_numpy(np.ascontiguousarray(img))).numpy()
    np.testing.assert_array_equal(out, ref)  # -inf on the 3-pixel border on both


def test_gaussian_blur(frame):
    img = frame[0].astype(np.float32)
    for sigma in (2.0, 1.2):
        ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma=sigma))
        out = timage.gaussian_blur(torch.from_numpy(img), sigma=sigma).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Orientation and steered BRIEF
# ---------------------------------------------------------------------------


def _bin_edge_distance(theta):
    step = 2 * np.pi / tbrief.NUM_BINS
    frac = theta / step - np.floor(theta / step)
    return np.abs(frac - 0.5) * step


def test_orientation_and_descriptors(detections):
    kps, _, valid, blurred = detections
    theta_j = np.asarray(jbrief.compute_orientations(jnp.asarray(blurred), jnp.asarray(kps), jnp.asarray(valid)))
    desc_j = np.asarray(jbrief.brief_describe(
        jnp.asarray(blurred), jnp.asarray(kps), jnp.asarray(theta_j), jnp.asarray(valid), method="gather"))
    theta, desc = tbrief.orient_and_describe(
        torch.from_numpy(blurred), torch.from_numpy(kps), torch.from_numpy(valid))
    theta, desc = theta.numpy(), desc.numpy().view(np.uint32)
    np.testing.assert_allclose(theta, theta_j, rtol=0, atol=1e-4)
    same = (desc == desc_j).all(axis=1)
    assert same[~valid].all()  # invalid rows are zero on both sides
    away = valid & (_bin_edge_distance(theta_j) > 1e-3)
    assert same[away].all()
    assert same[valid].mean() >= 0.99


def test_detect_and_describe(frame):
    img = frame[1]
    ref = [np.asarray(a) for a in jbrief.detect_and_describe(
        jnp.asarray(img), threshold=12.0, max_keypoints=512, border=19)]
    out = [a.numpy() for a in tbrief.detect_and_describe(
        torch.from_numpy(img), threshold=12.0, max_keypoints=512, border=19)]
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[1], ref[1])
    valid = ref[3]
    assert (out[2].view(np.uint32) == ref[2]).all(axis=1)[valid].mean() >= 0.99
    with pytest.raises(NotImplementedError, match="pyramid"):
        tbrief.detect_and_describe(torch.from_numpy(img), num_levels=2)


def test_pack_unpack_bits():
    rng = np.random.default_rng(1)
    for words in (8, 16):
        bits = rng.integers(0, 2, (37, 32 * words)).astype(np.uint32)
        ref = np.asarray(jbrief.pack_bits(jnp.asarray(bits)))
        packed = tbrief.pack_bits(torch.from_numpy(bits.astype(np.int64)))
        assert packed.dtype == torch.int32
        np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
        np.testing.assert_array_equal(tbrief.unpack_bits(packed).numpy(), bits.astype(np.float32))


def test_quantize_angle_and_tables():
    step = 2 * np.pi / tbrief.NUM_BINS
    rng = np.random.default_rng(2)
    theta = np.concatenate([
        rng.uniform(-np.pi, np.pi, 4000),
        (np.arange(-16, 16) + 0.5) * step,  # exact half-bin values, as float32
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        tbrief.quantize_angle(torch.from_numpy(theta)).numpy(),
        np.asarray(jbrief.quantize_angle(jnp.asarray(theta))),
    )
    np.testing.assert_array_equal(tbrief._ROT_A, jbrief._ROT_A)
    np.testing.assert_array_equal(tbrief._ROT_B, jbrief._ROT_B)
    np.testing.assert_array_equal(tbrief._MOMENT_WX, jbrief._MOMENT_WX)


def test_descriptor_registry():
    fam = tdesc.get_family("ORB")
    assert (fam.name, fam.words, fam.distance) == ("orb", 8, "hamming")
    assert tdesc.registered_families() == ["orb"]
    with pytest.raises(ValueError, match="unknown descriptor family 'brisk'"):
        tdesc.get_family("brisk")


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _noisy_copies(rng, base, flips):
    """Copies of packed descriptors with `flips` random bits flipped each."""
    out = base.copy()
    K, words = base.shape
    for i in range(K):
        for b in rng.choice(32 * words, flips, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _match_inputs(seed, K=512, words=8):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**32, (K, words), dtype=np.uint32)
    t = _noisy_copies(rng, q[rng.permutation(K)], 20)
    vq = rng.random(K) > 0.1
    vt = rng.random(K) > 0.1
    return q, vq, t, vt


def _t(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def test_ratio_test_match():
    q, vq, t, vt = _match_inputs(3)
    ref = jhamming.ratio_test_match(jnp.asarray(q), jnp.asarray(vq), jnp.asarray(t), jnp.asarray(vt), 0.6)
    out = thamming.ratio_test_match(_t(q), _t(vq), _t(t), _t(vt), 0.6)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[2].sum() > 100


@pytest.mark.parametrize("K", [512, 2048])
def test_best_percent_mask(K):
    """Integer distances with many ties: both tie-by-index paths (counting
    ranks up to K=1024, the sort cut above)."""
    rng = np.random.default_rng(K)
    dist = rng.integers(0, 40, (3, K)).astype(np.float32)
    matched = rng.random((3, K)) > 0.3
    matched[2] = False  # no matches: nothing kept
    for pct in (0.3, 0.77, 1.0):
        ref = np.stack([np.asarray(jhamming.best_percent_mask(jnp.asarray(d), jnp.asarray(m), pct))
                        for d, m in zip(dist, matched)])
        out = thamming.best_percent_mask(torch.from_numpy(dist), torch.from_numpy(matched), pct).numpy()
        np.testing.assert_array_equal(out, ref)


def test_dedup_per_train_keeps_exact_ties():
    rng = np.random.default_rng(5)
    W, K = 4, 64
    best = rng.integers(0, 8, (W, K)).astype(np.int32)  # many collisions
    d1 = rng.integers(0, 6, (W, K)).astype(np.float32)  # and many ties
    keep = rng.random((W, K)) > 0.2
    ref = np.asarray(jhamming._dedup_per_train(jnp.asarray(best), jnp.asarray(d1), jnp.asarray(keep)))
    out = thamming._dedup_per_train(torch.from_numpy(best), torch.from_numpy(d1), torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mutual", [True, False])
def test_match_window(mutual):
    rng = np.random.default_rng(6)
    W, K = 4, 256
    curr = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    window = np.stack([_noisy_copies(rng, curr[rng.permutation(K)], 10 + 8 * w) for w in range(W)])
    window[1, :40] = window[1, 40:80]  # duplicate claims for the one-to-one cut
    vw = rng.random((W, K)) > 0.1
    vc = rng.random(K) > 0.1
    ref = jhamming.match_window(jnp.asarray(window), jnp.asarray(vw), jnp.asarray(curr), jnp.asarray(vc),
                                0.6, 0.3, mutual=mutual)
    out = thamming.match_window(_t(window), _t(vw), _t(curr), _t(vc), 0.6, 0.3, mutual=mutual)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out[2].sum() > 50


# ---------------------------------------------------------------------------
# Geometry and configuration
# ---------------------------------------------------------------------------


def _intrinsics_pair():
    from vision_slam_frontend_tpu.frontend.config import DEFAULT_CALIB

    c = DEFAULT_CALIB["intrinsics_left"]
    return jcam.Intrinsics.create(**c), tcam.Intrinsics.create(**c)


def test_undistort_points():
    ji, ti = _intrinsics_pair()
    px = np.random.default_rng(7).uniform([0, 0], [960, 600], (500, 2)).astype(np.float32)
    ref = np.asarray(jcam.undistort_points(ji, jnp.asarray(px)))
    out = tcam.undistort_points(ti, torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def _stereo_pairs(config, n=2000, seed=8):
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-5, 5, n), rng.uniform(-1, 2, n), rng.uniform(3, 40, n)], 1)
    proj = lambda M: (lambda h: (h[:, :2] / h[:, 2:]))(np.c_[P, np.ones(n)] @ M.T.astype(np.float64))
    return proj(config.P_left).astype(np.float32), proj(config.P_right).astype(np.float32)


def lstsq_triangulate(P_left, P_right, pixels_left, pixels_right):
    """Independent float64 solve of the same normalized w = 1 DLT system."""
    out = []
    for ul, ur in zip(np.asarray(pixels_left, np.float64), np.asarray(pixels_right, np.float64)):
        rows = []
        for P, (u, v) in ((np.asarray(P_left, np.float64), ul), (np.asarray(P_right, np.float64), ur)):
            for r in (u * P[2] - P[0], v * P[2] - P[1]):
                rows.append(r / max(np.linalg.norm(r), 1e-12))
        A = np.array(rows)
        out.append(np.linalg.lstsq(A[:, :3], -A[:, 3], rcond=None)[0])
    return np.array(out).reshape(-1, 3)


def check_points(out, ref, exact):
    """The port solves in float64: it sits on the exact solution, and it
    differs from the reference by the reference's own float32 error."""
    norm = np.linalg.norm(exact, axis=-1)
    assert (np.linalg.norm(out - exact, axis=-1) <= 1e-5 * norm).all()
    assert (np.linalg.norm(out - ref, axis=-1) <= np.linalg.norm(ref - exact, axis=-1) + 1e-4 * norm).all()


def test_triangulate_points():
    config = JaxConfig(calib=SyntheticRig().calib())
    ul, ur = _stereo_pairs(config)
    ref = np.asarray(jcam.triangulate_points(
        jnp.asarray(config.P_left), jnp.asarray(config.P_right), jnp.asarray(ul), jnp.asarray(ur)))
    out = tcam.triangulate_points(torch.from_numpy(config.P_left), torch.from_numpy(config.P_right),
                                  torch.from_numpy(ul), torch.from_numpy(ur))
    assert out.dtype == torch.float32
    check_points(out.numpy(), ref, lstsq_triangulate(config.P_left, config.P_right, ul, ur))
    rel = np.linalg.norm(out.numpy() - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.median(rel) < 1e-4


def test_epipolar_residual():
    config = JaxConfig()
    ul, ur = _stereo_pairs(config, 500, 9)
    ur = ur + np.random.default_rng(10).normal(0, 2, ur.shape).astype(np.float32)
    F = np.asarray(config.fundamental, np.float32)
    ref = np.asarray(jcam.epipolar_residual(jnp.asarray(F), jnp.asarray(ul), jnp.asarray(ur)))
    out = tcam.epipolar_residual(torch.from_numpy(F), torch.from_numpy(ul), torch.from_numpy(ur)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_quat_to_matrix():
    q = np.random.default_rng(11).normal(size=(50, 4)).astype(np.float32)
    ref = np.asarray(jax.vmap(jrot.quat_to_matrix)(jnp.asarray(q)))
    np.testing.assert_allclose(trot.quat_to_matrix(torch.from_numpy(q)).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("calib", ["default", "synthetic"])
def test_config_derived_matrices(calib):
    kw = {} if calib == "default" else {"calib": SyntheticRig().calib()}
    ref, out = JaxConfig(**kw), FrontendConfig(**kw)
    for name in ("K_left", "K_right", "P_left", "P_right", "fundamental", "left_cam_to_robot"):
        a, b = np.asarray(getattr(out, name)), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), name
    for K in (out.K_left, out.K_right):
        np.testing.assert_array_equal(tcam.inv_camera_matrix(K), np.asarray(jnp.linalg.inv(jnp.asarray(K))))
    for side in ("intrinsics_left", "intrinsics_right"):
        ji, ti = getattr(ref, side), getattr(out, side)
        for f in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"):
            assert getattr(ti, f) == float(getattr(ji, f)), (side, f)


def test_config_rejects_options_not_ported():
    with pytest.raises(NotImplementedError, match="pyramid"):
        FrontendConfig(num_levels=3)
    with pytest.raises(NotImplementedError, match="debug_images"):
        FrontendConfig(debug_images=True)
    with pytest.raises(NotImplementedError, match="validate"):
        FrontendConfig(validate=True)
    with pytest.raises(ValueError, match="unknown descriptor family"):
        FrontendConfig(descriptor_family="akaze")


def test_config_load_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"max_features": 256, "frame_life": 5}))
    cfg = FrontendConfig.load(str(path))
    assert (cfg.max_features, cfg.frame_life) == (256, 5)
    path.write_text(yaml.safe_dump({"no_such_key": 1}))
    with pytest.raises(ValueError, match="Unknown config keys"):
        FrontendConfig.load(str(path))
