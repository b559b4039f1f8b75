"""The port's BRISK, FREAK and AKAZE families against the JAX package's, on
the CPU at a small size.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances:
  - patches, keypoint indices, FAST and Hessian NMS masks, validity, track
    ids and Hamming indices and distances: exact;
  - descriptor words: exact wherever the two orientation bins agree, and at
    least 99% of words equal overall (the orientation sums are float32
    products whose summation order XLA chooses; the port sums in float64);
  - AKAZE: at least 99% of the cell-mean bits and of the keypoints equal,
    the equal keypoints within 1e-4 px.
On these inputs every comparison is in fact exact; the looser bounds are
the contract.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vision_slam_frontend_tpu.frontend import keyframe as jkf  # noqa: E402
from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.ops import akaze as jakaze  # noqa: E402
from vision_slam_frontend_tpu.ops import brief as jbrief  # noqa: E402
from vision_slam_frontend_tpu.ops import brisk as jbrisk  # noqa: E402
from vision_slam_frontend_tpu.ops import freak as jfreak  # noqa: E402
from vision_slam_frontend_tpu.ops.fast import fast_detect as j_fast_detect  # noqa: E402
from vision_slam_frontend_tpu.utils import np_geom  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import keyframe as tkf  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import akaze as takaze  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import brief as tbrief  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import brisk as tbrisk  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import freak as tfreak  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family, registered_families  # noqa: E402
from test_torch_ops import lstsq_triangulate  # noqa: E402

SHAPE = (160, 192)
K = 64
CPU = torch.device("cpu")
FAST_FAMILIES = {
    "brisk": (jbrisk, tbrisk, jbrisk.brisk_describe, tbrisk.brisk_describe),
    "freak": (jfreak, tfreak, jfreak.freak_describe, tfreak.freak_describe),
}


def _image(seed, shape=SHAPE):
    """A corner-rich uint8 image: random rectangles plus noise."""
    rng = np.random.default_rng(seed)
    img = np.full(shape, 120.0)
    for _ in range(80):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        h, w = rng.integers(3, 20, 2)
        img[y : y + h, x : x + w] = rng.uniform(10, 245)
    img += rng.normal(0, 3.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _np(t):
    return t.cpu().numpy()


def _check_descriptors(desc, ref, theta, ref_theta):
    """Words exact where the bins agree; >= 99% of words equal overall."""
    desc = np.asarray(desc).view(np.uint32)
    ref = np.asarray(ref).view(np.uint32)
    bins = _np(tbrief.quantize_angle(torch.from_numpy(np.asarray(theta))))
    ref_bins = _np(tbrief.quantize_angle(torch.from_numpy(np.asarray(ref_theta))))
    same = bins == ref_bins
    np.testing.assert_array_equal(desc[same], ref[same])
    assert (desc == ref).mean() >= 0.99
    assert same.mean() >= 0.95


def _check_extractor_outputs(out, ref):
    """(keypoints, scores, descriptors, valid) against the reference's."""
    kps, scores, desc, valid = (_np(a) for a in out)
    r_kps, r_scores, r_desc, r_valid = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(valid, r_valid)
    same = np.abs(kps - r_kps).max(1) <= 1e-4
    assert same.mean() >= 0.99
    np.testing.assert_allclose(scores[same], r_scores[same], rtol=1e-4)
    assert (desc.view(np.uint32) == r_desc).mean() >= 0.99
    assert valid.sum() > K // 2


def test_registry_lists_the_ported_families():
    assert registered_families() == ["akaze", "brisk", "freak", "orb", "sift"]
    for name in ("brisk", "freak", "akaze"):
        assert get_family(name).words == 16 and get_family(name).distance == "hamming"
    assert (get_family("sift").words, get_family("sift").distance) == (128, "l2")
    with pytest.raises(ValueError, match="registered: \\['akaze', 'brisk', 'freak', 'orb', 'sift'\\]"):
        get_family("surf")


@pytest.mark.parametrize("family", sorted(FAST_FAMILIES))
def test_ring_pattern_constants(family):
    """The steering table equals the reference's quadrant flip followed by
    its fine-bin index, for every bin and point."""
    jmod, tmod, _, _ = FAST_FAMILIES[family]
    np.testing.assert_array_equal(tmod.PATTERN.idx0, jmod._IDX0)
    np.testing.assert_array_equal(tmod.PATTERN.grad_w, jmod._GRAD_W)
    pairs = jmod._SHORT_PAIRS if family == "brisk" else jmod._BIT_PAIRS
    np.testing.assert_array_equal(tmod.PATTERN.pairs, pairs)
    n = tbrisk.PATCH_SIZE
    planes = tmod.PATTERN.table.max() // tbrisk.PATCH_AREA + 1
    rng = np.random.default_rng(3)
    p = rng.normal(size=(tbrisk.NUM_BINS, planes, n, n)).astype(np.float32)
    rotated = {0: p, 1: np.flip(p, 3).transpose(0, 1, 3, 2), 2: np.flip(p, (2, 3)),
               3: np.flip(p.transpose(0, 1, 3, 2), 3)}
    rot_idx = jmod._ROT_IDX[: tbrisk.NUM_FINE]
    for b in range(tbrisk.NUM_BINS):
        q, f = divmod(b, tbrisk.NUM_FINE)
        want = rotated[q][b].reshape(-1)[rot_idx[f]]
        np.testing.assert_array_equal(p[b].reshape(-1)[tmod.PATTERN.table[b]], want)


@pytest.mark.parametrize("family", sorted(FAST_FAMILIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fast_family_describe_matches_jax(family, seed):
    jmod, tmod, j_describe, t_describe = FAST_FAMILIES[family]
    img = _image(seed)
    kps, _, valid = j_fast_detect(jnp.asarray(img, jnp.float32), threshold=12.0, max_keypoints=K,
                                  border=jmod.BORDER)
    kps, valid = np.asarray(kps), np.asarray(valid)
    desc_j, theta_j = j_describe(jnp.asarray(img, jnp.float32), jnp.asarray(kps), jnp.asarray(valid))
    desc, theta = t_describe(torch.from_numpy(img).float(), torch.from_numpy(kps), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(theta), np.asarray(theta_j), rtol=0, atol=1e-5)
    _check_descriptors(_np(desc), desc_j, _np(theta), theta_j)


@pytest.mark.parametrize("family", sorted(FAST_FAMILIES))
def test_fast_family_patches_match_jax_gather(family):
    """The patch kernel's plain version on the family's plane stack equals
    the reference's slab gather, exactly."""
    jmod, tmod, _, _ = FAST_FAMILIES[family]
    img = _image(4)
    rng = np.random.default_rng(4)
    kps = rng.uniform(-3, [SHAPE[1] + 3, SHAPE[0] + 3], (K, 2)).astype(np.float32)
    kps[:4] = [[13.5, 13.5], [100.5, 50.5], [0.0, 0.0], [191.0, 159.0]]
    extract = jbrisk._extract_multiscale_patches if family == "brisk" else jfreak._extract_retina_patches
    ref = np.asarray(extract(jnp.asarray(img, jnp.float32), jnp.asarray(kps)))
    got = tbrisk.blurred_patches(torch.from_numpy(img).float(), torch.from_numpy(kps), tmod.SIGMAS)
    np.testing.assert_array_equal(_np(got), ref)


@pytest.mark.parametrize("family", ["akaze", "brisk", "freak"])
@pytest.mark.parametrize("num_levels", [1, 2])
def test_registry_extractor_matches_jax(family, num_levels):
    img = _image(5 + num_levels)
    j_extract = {"brisk": jbrisk.detect_and_describe_brisk, "freak": jfreak.detect_and_describe_freak,
                 "akaze": jakaze.detect_and_describe_akaze}[family]
    ref = j_extract(jnp.asarray(img), threshold=12.0, max_keypoints=K, num_levels=num_levels)
    out = get_family(family).extractor(torch.from_numpy(img), threshold=torch.tensor(12.0),
                                       max_keypoints=K, num_levels=num_levels)
    _check_extractor_outputs(out, ref)


def test_akaze_scale_space_and_response_match_jax():
    img = _image(8).astype(np.float32)
    levels_j = jakaze.build_scale_space(jnp.asarray(img), 2, 1.4)
    levels = takaze.build_scale_space(torch.from_numpy(img), 2, 1.4)
    k2_j = jakaze._contrast_k2(jax.numpy.asarray(_jax_blur(img)))
    k2 = takaze.contrast_k2(torch.from_numpy(_jax_blur(img)))
    np.testing.assert_allclose(_np(k2), np.asarray(k2_j), rtol=1e-6)
    for L, L_j, sigma in zip(levels, levels_j, takaze.evolution_sigmas(2, 1.4)):
        np.testing.assert_allclose(_np(L), np.asarray(L_j), rtol=0, atol=1e-4)
        resp = takaze.hessian_response(L, sigma)
        resp_j = jakaze.hessian_response(L_j, sigma)
        np.testing.assert_allclose(_np(resp), np.asarray(resp_j), rtol=1e-4, atol=1e-2)
        # The Hessian NMS mask on the same response: exact.
        kps, _, valid = takaze.detect_on_response(torch.from_numpy(np.asarray(resp_j)), 144.0, K, 19)
        kps_j, _, valid_j = jakaze._detect_on_response(resp_j, 144.0, K, 19)
        np.testing.assert_array_equal(_np(valid), np.asarray(valid_j))
        np.testing.assert_allclose(_np(kps), np.asarray(kps_j), rtol=0, atol=1e-4)


def _jax_blur(img):
    from vision_slam_frontend_tpu.ops.image import gaussian_blur

    return np.asarray(gaussian_blur(jnp.asarray(img, jnp.float32), sigma=takaze.SIGMA0))


def test_akaze_describe_matches_jax():
    img = _image(9).astype(np.float32)
    L_j = jakaze.build_scale_space(jnp.asarray(img), 1, 1.4)[0]
    Lx_j, Ly_j = jakaze._grad_central(L_j)
    resp_j = jakaze.hessian_response(L_j, takaze.evolution_sigmas(1, 1.4)[0])
    kps, _, valid = (np.asarray(a) for a in jakaze._detect_on_response(resp_j, 144.0, K, 19))
    desc_j, theta_j = jakaze.akaze_describe(L_j, Lx_j, Ly_j, jnp.asarray(kps), jnp.asarray(valid))
    t = lambda a: torch.from_numpy(np.asarray(a))
    desc, theta = takaze.akaze_describe(t(L_j), t(Lx_j), t(Ly_j), t(kps), t(valid))
    np.testing.assert_allclose(_np(theta), np.asarray(theta_j), rtol=0, atol=1e-5)
    bits = np.unpackbits(_np(desc).view(np.uint8), axis=1)
    bits_j = np.unpackbits(np.asarray(desc_j).view(np.uint8), axis=1)
    assert (bits == bits_j).mean() >= 0.99
    _check_descriptors(_np(desc), desc_j, _np(theta), theta_j)
    # The patch kernel's plain version equals the reference's 3-channel gather.
    p3 = ck.extract_patches(torch.stack([t(L_j), t(Lx_j), t(Ly_j)]), t(kps), 31)
    p3_j = jbrief.extract_patches(jnp.stack([L_j, Lx_j, Ly_j], axis=-1), jnp.asarray(kps))
    np.testing.assert_array_equal(_np(p3).transpose(0, 2, 1), np.asarray(p3_j))


# ---------------------------------------------------------------------------
# keyframe_step, teacher-forced, per family
# ---------------------------------------------------------------------------

NUM_KEYFRAMES = 4
RIG = dict(width=512, height=384, cx=256.0, cy=192.0, fx=420.0, fy=420.0)
STEP_KW = dict(capacity=K, window=3, border=19, blur_sigma=2.0, mutual_check=True)


def _leaves(obj):
    host = jax.device_get(obj)
    return {f.name: np.array(getattr(host, f.name)) for f in dataclasses.fields(host)}


def _as_numpy(obj):
    out = {f.name: getattr(obj, f.name).cpu().numpy() for f in dataclasses.fields(obj)}
    if "desc" in out:
        out["desc"] = out["desc"].view(np.uint32)
    return out


@pytest.fixture(scope="module", params=["akaze", "brisk", "freak"])
def family_trajectory(request):
    """Per keyframe: (reference state before, step inputs, reference result,
    reference state after) of the JAX step, as numpy."""
    family = request.param
    rig = SyntheticRig(**RIG)
    frames = list(generate_sequence(num_frames=NUM_KEYFRAMES + 1, rig=rig))
    q0_inv = np_geom.quat_inverse(np_geom.quat_normalize(frames[0].odom_rotation))
    config = JaxConfig(calib=rig.calib(), fast_threshold=12.0, descriptor_family=family)
    params = jkf.StepParams.from_config(config)
    state = jkf.WindowState.create(STEP_KW["window"], K, config.stereo_threshold_init, words=16)
    out = []
    for k in range(1, NUM_KEYFRAMES + 1):
        f = frames[k]
        pose_t = np_geom.quat_rotate(q0_inv, f.odom_translation - frames[0].odom_translation).astype(np.float32)
        pose_q = np_geom.quat_multiply(np_geom.quat_normalize(f.odom_rotation), q0_inv).astype(np.float32)
        left = np.clip(f.left, 0, 255).astype(np.uint8)
        right = np.clip(f.right, 0, 255).astype(np.uint8)
        before = _leaves(state)
        state, result = jkf.keyframe_step(params, state, left, right, np.int32(k - 1),
                                          curr_pose_t=pose_t, curr_pose_q=pose_q,
                                          descriptor_family=family, **STEP_KW)
        out.append((before, (left, right, k - 1, pose_t, pose_q), _leaves(result), _leaves(state)))
    return family, rig, out


def _exact_points(config, result):
    """Float64 solve of a result's undistorted stereo pairs; zero rows where
    it has no feature."""
    valid = result["feat_valid"]
    exact = np.zeros((len(valid), 3))
    exact[valid] = lstsq_triangulate(config.P_left, config.P_right,
                                     result["pixels_undist"][valid], result["right_pixels_undist"][valid])
    return exact


def _check_points(out, ref, exact, exact_ref):
    """The port solves in float64: it sits on the exact solve of its own
    pixels (`exact`), and it differs from the reference by no more than the
    reference's own float32 error (against `exact_ref`, the solve of the
    reference's pixels) plus what the two sets of pixels change."""
    norm = np.linalg.norm(exact, axis=-1)
    assert (np.linalg.norm(out - exact, axis=-1) <= 1e-5 * norm).all()
    bound = (np.linalg.norm(ref - exact_ref, axis=-1) + np.linalg.norm(exact - exact_ref, axis=-1)
             + 1e-4 * norm)
    assert (np.linalg.norm(out - ref, axis=-1) <= bound).all()


def _compare_step(out, ref, what, exact_points, exact_ref):
    """Int and bool fields exact; descriptor words >= 99% equal; 3D points
    by _check_points; other floats within 1e-3."""
    assert out.keys() == ref.keys(), what
    for name, b in ref.items():
        a = out[name]
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if name == "desc":
            assert (a == b).mean() >= 0.99, (what, name)
        elif b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")
        elif name == "points3d":
            real = np.linalg.norm(b, axis=-1) > 0
            np.testing.assert_array_equal(a[~real], 0.0)
            _check_points(a[real], b[real], exact_points[real], exact_ref[real])
        elif name == "stereo_threshold":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{what}.{name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=f"{what}.{name}")


def test_keyframe_step_teacher_forced_per_family(family_trajectory):
    family, rig, trajectory = family_trajectory
    config = FrontendConfig(calib=rig.calib(), fast_threshold=12.0, descriptor_family=family)
    params = tkf.StepParams.from_config(config, CPU)
    matched = 0
    for before, (left, right, fid, pose_t, pose_q), ref_result, ref_state in trajectory:
        state = tkf.WindowState.from_numpy(before, CPU)
        t = torch.from_numpy
        new_state, result = tkf.keyframe_step(params, state, t(left), t(right), fid,
                                              curr_pose_t=t(pose_t), curr_pose_q=t(pose_q),
                                              descriptor_family=family, **STEP_KW)
        res = _as_numpy(result)
        exact, exact_ref = _exact_points(config, res), _exact_points(config, ref_result)
        _compare_step(res, ref_result, f"{family} keyframe {fid + 1} KeyframeResult", exact, exact_ref)
        new_row = ref_state["frame_id"] == fid
        state_exact = ref_state["points3d"].astype(np.float64)
        state_exact_ref = state_exact.copy()
        state_exact[new_row], state_exact_ref[new_row] = exact, exact_ref
        _compare_step(_as_numpy(new_state), ref_state, f"{family} keyframe {fid + 1} WindowState",
                      state_exact, state_exact_ref)
        assert new_state.desc.shape == (STEP_KW["window"], K, 16)
        matched += int(res["window_matched"].sum())
    assert res["num_features"] > 10 and matched >= 5
