"""The port's SIFT family and L2 matching against the JAX package's, on the
CPU at a small size, and the port's counterparts of tests/test_sift.py's
behavioral cases.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances:
  - spatial weight tables: exact;
  - squared-L2 distance matrices of unit-norm 128-d rows: 1e-4 absolute (the
    reference's cross term is three bf16 passes, about 16 input bits; the
    port's is exact, computed in float64 and rounded once);
  - kNN(2), the ratio test and the window match: indices and masks equal
    wherever the JAX package's top-2 gap and ratio margin |d1 - ratio*d2|
    (and, for the window, its distance's gap to the frame's best-percent cut)
    exceed 1e-4; at least 99.5% equal overall; the distances of shared
    matches within 1e-4;
  - describe: 1e-5 on patches whose orientation bins lie away from bin edges;
  - the extractor: valid exact, and keypoints and scores exact at the first
    pyramid level (a resized level: keypoints within 1e-4 px, scores 1e-4
    relative, the resize's own tolerance); descriptors within 1e-5 where the
    two orientation bins agree, on at least 99% of the valid rows;
  - the frontend on the golden-loop fixture: node and feature counts and the
    vision factors' match lists equal (where they would differ, only where
    the JAX package's own ratio margin is under 1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from vision_slam_frontend_tpu.frontend import Frontend as JaxFrontend  # noqa: E402
from vision_slam_frontend_tpu.frontend import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.ops import hamming as jham  # noqa: E402
from vision_slam_frontend_tpu.ops import sift as jsift  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import hamming as tham  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import sift as tsift  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.brief import quantize_angle  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family, registered_families  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur, resize_linear  # noqa: E402

MARGIN = 1e-4
RATIO = 0.6
K = 128
W = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _unit_rows(rng, n, d=128):
    x = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _match_inputs(seed):
    """A current frame of K unit-norm rows (some invalid), and W past frames
    of noisy, shuffled copies of most of its rows plus unrelated ones."""
    rng = np.random.default_rng(seed)
    curr = _unit_rows(rng, K)
    valid_curr = rng.random(K) > 0.1
    window = []
    for w in range(W):
        perm = rng.permutation(K)
        noisy = curr[perm] + rng.normal(0, 0.006 * (w + 1), (K, 128)).astype(np.float32)
        noisy = np.abs(noisy) / np.linalg.norm(noisy, axis=1, keepdims=True)
        other = _unit_rows(rng, K)
        window.append(np.where((rng.random(K) < 0.8)[:, None], noisy, other).astype(np.float32))
    valid_window = rng.random((W, K)) > 0.1
    return np.stack(window), valid_window, curr, valid_curr


def _jax_top2(q, t, valid_t):
    """The JAX package's (best, d1, d2) as numpy."""
    i, d1, d2 = jham._l2_knn2(jnp.asarray(q), jnp.asarray(t), jnp.asarray(valid_t))
    return np.asarray(i), np.asarray(d1), np.asarray(d2)


def _clear(d1, d2, valid_q):
    """Where the reference's own top-2 gap and ratio margin exceed MARGIN."""
    return valid_q & (d2 - d1 > MARGIN) & (np.abs(d1 - RATIO * d2) > MARGIN)


def test_spatial_weight_tables_equal_the_jax_packages():
    np.testing.assert_array_equal(tsift._SPATIAL, jsift._SPATIAL)
    assert tsift.DIMS == jsift.DIMS and tsift.NUM_FINE == 8 and tsift.PATCH_AREA == jsift.PATCH_AREA


def test_l2_sq_distance_matrix_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    q, t = _unit_rows(rng, 300), _unit_rows(rng, 200)
    exact = ((q.astype(np.float64)[:, None] - t[None]) ** 2).sum(-1)
    ours = _np(tham.l2_sq_distance_matrix(_t(q), _t(t)))
    ref = np.asarray(jham.l2_sq_distance_matrix(jnp.asarray(q), jnp.asarray(t)))
    assert np.abs(ours - ref).max() <= 1e-4
    assert np.abs(ours - exact).max() <= 1e-6  # one float32 rounding of the exact value
    assert ours.dtype == np.float32


@pytest.mark.parametrize("seed", [1, 2])
def test_l2_knn2_and_ratio_test_equal_the_jax_packages(seed):
    window, valid_window, curr, valid_curr = _match_inputs(seed)
    q = window[0]
    valid_q = valid_window[0]
    ji, jd1, jd2 = _jax_top2(q, curr, valid_curr)
    ti, td1, td2 = (_np(a) for a in tham._l2_knn2(_t(q), _t(curr), _t(valid_curr)))
    clear = _clear(jd1, jd2, np.ones(K, bool))
    np.testing.assert_array_equal(ti[clear], ji[clear])
    assert (ti == ji).mean() >= 0.995
    np.testing.assert_allclose(td1, jd1, atol=MARGIN)
    np.testing.assert_allclose(td2, jd2, atol=MARGIN)

    ref = [np.asarray(a) for a in jham.ratio_test_match(jnp.asarray(q), jnp.asarray(valid_q), jnp.asarray(curr),
                                                        jnp.asarray(valid_curr), ratio=RATIO)]
    out = [_np(a) for a in tham.ratio_test_match(_t(q), _t(valid_q), _t(curr), _t(valid_curr), RATIO)]
    clear = _clear(jd1, jd2, valid_q)
    for a, b in ((out[0], ref[0]), (out[2], ref[2])):
        np.testing.assert_array_equal(a[clear], b[clear])
        assert (a == b).mean() >= 0.995
    shared = out[2] & ref[2]
    assert shared.sum() > K // 4
    np.testing.assert_allclose(out[1][shared], ref[1][shared], atol=MARGIN)
    assert out[0].dtype == np.int32 and out[2].dtype == bool


def test_ratio_test_rejects_the_no_valid_train_sentinel():
    rng = np.random.default_rng(3)
    q, t = _unit_rows(rng, 8), _unit_rows(rng, 4)
    idx, dist, matched = tham.ratio_test_match(_t(q), torch.ones(8, dtype=torch.bool), _t(t),
                                               torch.zeros(4, dtype=torch.bool), RATIO)
    assert not bool(matched.any()) and bool((dist == 1e9).all()) and bool((idx == 0).all())


@pytest.mark.parametrize("mutual", [False, True], ids=["plain", "mutual"])
def test_match_window_l2_equals_the_jax_packages(mutual):
    window, valid_window, curr, valid_curr = _match_inputs(4)
    best_percent = 0.5
    ref = [np.asarray(a) for a in jham.match_window(jnp.asarray(window), jnp.asarray(valid_window),
                                                    jnp.asarray(curr), jnp.asarray(valid_curr), RATIO,
                                                    best_percent, mutual=mutual)]
    out = [_np(a) for a in tham.match_window(_t(window), _t(valid_window), _t(curr), _t(valid_curr),
                                             torch.tensor(RATIO), torch.tensor(best_percent), mutual=mutual)]
    # The reference's margins: top-2 gap, ratio margin, and the gap between
    # each ratio-test survivor's distance and its frame's best-percent cut
    # and the other survivors' distances.
    ji, jd1, jd2 = _jax_top2(window.reshape(W * K, -1), curr, valid_curr)
    jd1, jd2 = jd1.reshape(W, K), jd2.reshape(W, K)
    clear = _clear(jd1, jd2, valid_window)
    passed = valid_window & (jd1 < RATIO * jd2)
    for w in range(W):
        d = np.sort(jd1[w][passed[w]])
        near = np.abs(jd1[w][:, None] - d[None, :])
        near = np.where(near == 0, np.inf, near).min(1) if len(d) > 1 else np.full(K, np.inf)
        clear[w] &= near > MARGIN
    for a, b in ((out[0], ref[0]), (out[2], ref[2])):
        np.testing.assert_array_equal(a[clear], b[clear])
        assert (a == b).mean() >= 0.995
    shared = out[2] & ref[2]
    assert shared.sum() > W * K // 8
    np.testing.assert_allclose(out[1][shared], ref[1][shared], atol=MARGIN)


def test_rotate_patches_90_equals_the_jax_packages():
    from vision_slam_frontend_tpu.ops.brief import _rotate_patches_90

    rng = np.random.default_rng(5)
    patches = rng.uniform(0, 255, (8, tsift.PATCH_AREA)).astype(np.float32)
    quad = np.arange(8) % 4
    np.testing.assert_array_equal(_np(tsift.rotate_patches_90(_t(patches), _t(quad))),
                                  np.asarray(_rotate_patches_90(jnp.asarray(patches), jnp.asarray(quad))))


def test_sift_describe_patches_equals_the_jax_packages():
    rng = np.random.default_rng(6)
    n = 96
    base = rng.uniform(0, 255, (n, 8, 8))
    patches = (np.kron(base, np.ones((4, 4)))[:, :31, :31].reshape(n, -1)
               + rng.normal(0, 4.0, (n, 961))).astype(np.float32)
    step = 2 * np.pi / 32
    orient = ((np.arange(n) % 32 + rng.uniform(-0.3, 0.3, n)) * step - 2 * np.pi * (np.arange(n) % 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    ours = _np(tsift.sift_describe_patches(_t(patches), _t(orient), _t(valid)))
    ref = np.asarray(jsift.sift_describe_patches(jnp.asarray(patches), jnp.asarray(orient), jnp.asarray(valid)))
    np.testing.assert_array_equal(_np(quantize_angle(_t(orient))) % 32, np.arange(n) % 32)
    assert np.abs(ours - ref).max() <= 1e-5
    assert ours.dtype == np.float32 and not ours[~valid].any()
    np.testing.assert_allclose(np.linalg.norm(ours[valid], axis=1), 1.0, atol=1e-5)


def _level_thetas(pkg, image, kps, valid, num_levels):
    """Each level's orientations of the extractor's keypoints, by the
    package's own blur, resize and orient."""
    H, Wd = image.shape
    budget = K // num_levels
    budgets = [budget] * (num_levels - 1) + [K - budget * (num_levels - 1)]
    out, start, scale = [], 0, 1.0
    for lvl, b in enumerate(budgets):
        if lvl > 0:
            scale *= 1.4
            shape = (max(int(round(H / scale)), 46), max(int(round(Wd / scale)), 46))
        sl = slice(start, start + b)
        lk = (kps[sl] / scale).astype(np.float32)
        if pkg == "jax":
            from jax.image import resize

            from vision_slam_frontend_tpu.ops.image import gaussian_blur as jblur

            img = jnp.asarray(image) if lvl == 0 else resize(jnp.asarray(image), shape, method="linear")
            th, _ = jsift.orient_and_describe_sift(jblur(img, sigma=2.0), jnp.asarray(lk), jnp.asarray(valid[sl]))
        else:
            img = _t(image) if lvl == 0 else resize_linear(_t(image), shape)
            th, _ = tsift.orient_and_describe_sift(gaussian_blur(img, sigma=2.0), _t(lk), _t(valid[sl]))
        out.append(_np(th))
        start += b
    return np.concatenate(out)


@pytest.mark.parametrize("num_levels", [1, 2])
def test_detect_and_describe_sift_equals_the_jax_packages(num_levels):
    rng = np.random.default_rng(6)
    image = rng.uniform(0, 255, (160, 200)).astype(np.float32)
    ref = [np.asarray(a) for a in jsift.detect_and_describe_sift(jnp.asarray(image), threshold=10.0,
                                                                 max_keypoints=K, num_levels=num_levels)]
    out = [_np(a) for a in tsift.detect_and_describe_sift(_t(image), threshold=10.0, max_keypoints=K,
                                                          num_levels=num_levels)]
    # Level 0 exactly; a resized level within the resize's own tolerance
    # (ops/image.resize_linear: 1e-4, its sums' order against XLA's).
    lvl0 = K if num_levels == 1 else K // num_levels
    np.testing.assert_array_equal(out[0][:lvl0], ref[0][:lvl0])
    np.testing.assert_array_equal(out[1][:lvl0], ref[1][:lvl0])
    np.testing.assert_allclose(out[0][lvl0:], ref[0][lvl0:], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[1][lvl0:], ref[1][lvl0:], rtol=1e-4)
    np.testing.assert_array_equal(out[3], ref[3])
    valid = ref[3]
    assert valid.sum() > K // 2 and out[2].dtype == np.float32
    bins = [_np(quantize_angle(_t(_level_thetas(p, image, ref[0], valid, num_levels)))) for p in ("port", "jax")]
    close = np.abs(out[2] - ref[2]).max(1) <= 1e-5
    assert np.all(close[valid & (bins[0] == bins[1])])
    assert close[valid].mean() >= 0.99
    assert not out[2][~valid].any()


# --- the port's counterparts of tests/test_sift.py ---------------------------


def _textured_image(h=120, w=160, seed=3):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 255, (h // 4, w // 4)), np.ones((4, 4)))
    return img.astype(np.float32)


def test_registered():
    assert "sift" in registered_families()
    fam = get_family("sift")
    assert fam.words == 128 and fam.distance == "l2"


def test_extractor_contract():
    rng = np.random.default_rng(5)
    img = _t(rng.uniform(0, 255, (120, 160)).astype(np.float32))
    kps, scores, desc, valid = tsift.detect_and_describe_sift(img, threshold=10.0, max_keypoints=128)
    assert kps.shape == (128, 2) and desc.shape == (128, 128) and desc.dtype == torch.float32
    assert int(valid.sum()) > 20


def test_valid_mask_zeroes_and_distinct_keypoints():
    img = _t(_textured_image())
    kps = torch.tensor([[40.0, 40.0], [100.0, 70.0], [60.0, 90.0], [80.0, 60.0]])
    valid = torch.tensor([True, True, True, False])
    _, desc = tsift.orient_and_describe_sift(img, kps, valid)
    d = _np(desc)
    assert not d[3].any() and 0.9 < np.linalg.norm(d[0]) < 1.1
    for i in range(3):
        for j in range(i + 1, 3):
            assert np.linalg.norm(d[i] - d[j]) > 0.3, (i, j)


def test_rotation_invariant_descriptor():
    """The same point in the 180-degree turned image (an exact grid): its
    descriptor lies far closer than unrelated pairs."""
    img = _textured_image()
    rot = img[::-1, ::-1].copy()
    H, Wd = img.shape
    pts = [(50.0, 44.0), (90.0, 60.0), (70.0, 80.0)]
    v = torch.ones(len(pts), dtype=torch.bool)
    _, d0 = tsift.orient_and_describe_sift(_t(img), torch.tensor(pts), v)
    _, d1 = tsift.orient_and_describe_sift(_t(rot), torch.tensor([[Wd - 1 - x, H - 1 - y] for x, y in pts]), v)
    a, b = _np(d0), _np(d1)
    for i in range(len(pts)):
        same = np.linalg.norm(a[i] - b[i])
        others = [np.linalg.norm(a[i] - b[j]) for j in range(len(pts)) if j != i]
        assert same < 0.6 * min(others) and same < 0.8, (i, same, others)


def test_full_frontend_with_sift():
    rig = SyntheticRig()
    fe = Frontend(FrontendConfig(calib=rig.calib(), max_features=256, frame_life=5, fast_threshold=12.0,
                                 descriptor_family="sift"), device="cpu")
    for f in generate_sequence(num_frames=6, step=0.25, rig=rig):
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    p = fe.get_slam_problem()
    assert len(p.nodes) >= 5
    assert min(len(n.features) for n in p.nodes) > 40
    assert sum(len(vf.feature_matches) for vf in p.vision_factors) > 100
    assert fe._state.desc.dtype == torch.float32 and fe._state.desc.shape == (5, 256, 128)


def test_cli_descriptor_family_flag(tmp_path):
    from vision_slam_frontend_tpu_torch.cli.slam_frontend import main

    out = tmp_path / "p.npz"
    rc = main(["--input", "synthetic:5", "--output", str(out), "--descriptor_family", "sift",
               "--max_features", "128", "--device", "cpu"])
    assert rc == 0 and out.exists()


# --- the whole slice on the golden-loop fixture ------------------------------

LOOP_FRAMES = 10


def test_frontend_on_the_golden_loop_fixture_equals_the_jax_packages():
    """tests/test_golden_loop.py's fixture (512x384, K=256, W=8, seed 5, odometry
    drift 0.02, texture noise 2), its first frames with the sift family: the
    same keyframes, features, vision factors and match lists."""
    rig = SyntheticRig(width=512, height=384, cx=256.0, cy=192.0, fx=420.0, fy=420.0)
    frames = list(generate_sequence(num_frames=LOOP_FRAMES, step=0.25, rig=rig, yaw_rate=2 * np.pi / 210,
                                    odom_drift=0.02, seed=5, texture_noise=2.0))
    kw = dict(calib=rig.calib(), max_features=256, frame_life=8, fast_threshold=12.0, descriptor_family="sift")
    ref, port = JaxFrontend(JaxConfig(**kw)), Frontend(FrontendConfig(**kw), device="cpu")
    for fe in (ref, port):
        for f in frames:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
    a, b = port.get_slam_problem(), ref.get_slam_problem()
    assert len(a.nodes) == len(b.nodes) >= LOOP_FRAMES - 2
    assert [len(n.features) for n in a.nodes] == [len(n.features) for n in b.nodes]
    for na, nb in zip(a.nodes, b.nodes):
        np.testing.assert_allclose([f.pixel for f in na.features], [f.pixel for f in nb.features], atol=1e-4)
    assert len(a.vision_factors) == len(b.vision_factors)
    for va, vb in zip(a.vision_factors, b.vision_factors):
        assert (va.pose_idx_initial, va.pose_idx_current) == (vb.pose_idx_initial, vb.pose_idx_current)
        assert [(m.feature_idx_initial, m.feature_idx_current) for m in va.feature_matches] == \
            [(m.feature_idx_initial, m.feature_idx_current) for m in vb.feature_matches]
    assert sum(len(v.feature_matches) for v in a.vision_factors) > 200
    for ta, tb in zip(port.node_track_ids, ref.node_track_ids):
        np.testing.assert_array_equal(ta, tb)
