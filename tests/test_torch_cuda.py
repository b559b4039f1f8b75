"""The port on a CUDA GPU: each kernel against its plain PyTorch version at
the main paths' shapes, the keyframe step and Frontend on the card against
the CPU, for every descriptor family and the ORB pyramid, the two-step API
routes and nms=False, the L2 kNN,
frontend checkpoints and validate mode, the BA backend (a failed Cholesky, bit-equal reruns, the card against the CPU,
the CUDA default refused without a card), and the span recorder (no sync, no launch).

The tests marked `cuda` need the card and skip where there is none; the BA
tests' CPU cases and the refusal test run anywhere. The file imports no JAX
(the GPU machine has none), so it runs there on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Kernel outputs are integers (FAST scores, Hamming distances, indices) or
copies (patches), so every kernel comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import keyframe as tkf  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import akaze, brisk, freak  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
import torch_edge_cases as edge_cases  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.descriptors import descriptor_dtype, get_family  # noqa: E402
from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur, resize_linear  # noqa: E402
from vision_slam_frontend_tpu_torch.utils import cuda_timing, np_geom  # noqa: E402

NUM_FRAMES = 5
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames():
    return list(generate_sequence(num_frames=NUM_FRAMES, rig=SyntheticRig()))


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _config(**kw):
    return FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **kw)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda, frames):
    ck.reset_launch_counts()
    img = torch.from_numpy(_u8(frames[0].left)).to(cuda)  # 640x480
    raw, sup = ck.fast_scores_nms(img)
    raw_p, sup_p = ck.fast_scores_nms_plain(img)
    assert torch.equal(raw, raw_p) and torch.equal(sup, sup_p)

    # K=512 f16 patches of the blurred frame, with clamped corners and
    # exact .5 coordinates (round half to even).
    planes = gaussian_blur(img.float()).to(torch.float16)[None].contiguous()
    rng = np.random.default_rng(0)
    kps = rng.uniform(-5, [645, 485], (512, 2)).astype(np.float32)
    kps[:8] = [[0, 0], [639, 479], [-7, 3], [700, 500], [100.5, 200.5], [101.5, 33.5],
               [15.5, 15.5], [624.5, 464.5]]
    kps = torch.from_numpy(kps).to(cuda)
    assert torch.equal(ck.extract_patches(planes, kps, 31), ck.extract_patches_plain(planes, kps, 31))

    # Stereo 512x512 and window 5120x512 at 8 words, 16 words, and an
    # all-invalid train set (1e9 sentinels).
    for kq, kt, words, invalid in ((512, 512, 8, 0.3), (5120, 512, 8, 0.3), (300, 700, 16, 0.2),
                                   (64, 128, 8, 1.0)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(cuda)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(cuda)
        v = torch.from_numpy(rng.random(kt) >= invalid).to(cuda)
        for a, b in zip(ck.hamming_top2(q, t, v), ck.hamming_top2_plain(q, t, v)):
            assert torch.equal(a, b), (kq, kt, words, invalid)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"fast_scores_nms": 1, "extract_patches": 1, "hamming_top2": 4, "patch_windows": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(edge_cases.hamming_cases())))
def test_hamming_edge_cases_match_plain_on_the_card(cuda, case):
    """Ties at tile, warp and block boundaries, all distances equal, the
    only valid train last, Kt of 1, 511 and 513: exact."""
    label, arrays = edge_cases.hamming_cases()[case]
    q, t = (torch.from_numpy(a.view(np.int32)).to(cuda) for a in arrays[:2])
    v = torch.from_numpy(arrays[2]).to(cuda)
    for a, b in zip(ck.hamming_top2(q, t, v), ck.hamming_top2_plain(q, t, v)):
        assert torch.equal(a, b), label


@pytest.mark.cuda
@pytest.mark.parametrize("words", [8, 16])
def test_hamming_refuses_misaligned_trains_on_the_card(cuda, words):
    """Trains whose storage starts 4 bytes off a 16-byte boundary (a
    contiguous view at an element offset) are refused; a row slice, as
    callers make, is aligned and exact."""
    rng = np.random.default_rng(words)
    q = torch.from_numpy(rng.integers(0, 2**32, (200, words), dtype=np.uint32).view(np.int32)).to(cuda)
    t = torch.from_numpy(rng.integers(0, 2**32, (600, words), dtype=np.uint32).view(np.int32)).to(cuda)
    v = torch.from_numpy(rng.random(600) >= 0.3).to(cuda)
    flat = torch.zeros(t.numel() + 1, dtype=torch.int32, device=cuda)
    flat[1:] = t.reshape(-1)
    shifted = flat[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.hamming_top2(q, shifted, v)
    rows = t[1:]
    for a, b in zip(ck.hamming_top2(q, rows, v[1:]), ck.hamming_top2_plain(q, rows, v[1:])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counts_leave_out_graph_capture(cuda):
    """device_ms counts its warm-up calls as launches, not the calls it
    captures into a CUDA graph (they launch nothing)."""
    q = torch.zeros((64, 8), dtype=torch.int32, device=cuda)
    v = torch.ones(64, dtype=torch.bool, device=cuda)
    ck.reset_launch_counts()
    cuda_timing.device_ms(lambda: ck.hamming_top2(q, q, v))
    assert ck.LAUNCHES["hamming_top2"] == cuda_timing.WARMUP_CALLS


@pytest.mark.cuda
def test_device_ms_leaves_the_host_out(cuda):
    """device_ms (graph replay behind a spin) times the kernel alone: below
    the cost of one call, which includes the wrapper's host work."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(0, 2**32, (5120, 8), dtype=np.uint32).view(np.int32)).to(cuda)
    t = torch.from_numpy(rng.integers(0, 2**32, (512, 8), dtype=np.uint32).view(np.int32)).to(cuda)
    v = torch.ones(512, dtype=torch.bool, device=cuda)
    fn = lambda: ck.hamming_top2(q, t, v)  # noqa: E731
    device = cuda_timing.device_ms(fn)
    assert 0.0 < device < cuda_timing.call_ms(fn)


@pytest.mark.cuda
def test_profiled_kernel_ms_reports_a_missing_kernel_without_failing(cuda):
    """The profiler's cross-check gives None, not an error, for a kernel it
    did not record, and one kernel per call for the one it did (where the
    process has a device trace at all)."""
    q = torch.zeros((64, 8), dtype=torch.int32, device=cuda)
    v = torch.ones(64, dtype=torch.bool, device=cuda)
    fn = lambda: ck.hamming_top2(q, q, v)  # noqa: E731
    assert cuda_timing.profiled_kernel_ms(fn, "no_such_kernel")[:2] == (None, 0)
    ms, per_call, n_device = cuda_timing.profiled_kernel_ms(fn, "hamming_top2_kernel")
    assert (ms is None) == (n_device == 0)
    if ms is not None:
        assert ms > 0.0 and per_call == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(edge_cases.fast_cases())))
def test_fast_edge_cases_match_plain_on_the_card(cuda, case):
    """Ragged sizes, constant images, plateaus, a 0/255 checkerboard and a
    non-integer float32 level: exact."""
    label, img = edge_cases.fast_cases()[case]
    img = torch.from_numpy(img).to(cuda)
    for a, b in zip(ck.fast_scores_nms(img), ck.fast_scores_nms_plain(img)):
        assert torch.equal(a, b), label


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(edge_cases.patch_cases())))
def test_patch_edge_cases_match_plain_on_the_card(cuda, case):
    """Odd and ragged widths, planes at a 1-element offset, K from 1 to 513,
    C from 1 to 7, ps from 1 to 33 and equal to H or W, keypoints at the
    edges, outside and on .5: exact, one launch each."""
    label, planes, kps, ps, offset = edge_cases.patch_cases()[case]
    p = edge_cases.at_offset(planes, offset, cuda)
    k = torch.from_numpy(kps).to(cuda)
    ck.reset_launch_counts()
    out = ck.extract_patches(p, k, ps)
    assert ck.LAUNCHES["extract_patches"] == 1
    assert torch.equal(out, ck.extract_patches_plain(p, k, ps)), label


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(edge_cases.window_cases())))
def test_window_edge_cases_match_plain_on_the_card(cuda, case):
    """Windows leaving the image and past the probe's padding, xs at every
    residue mod 4, widths not a multiple of 4, K not a multiple of `block`,
    an image at a 1-element offset: exact, one launch each."""
    label, img, ys, xs, rows, shifted, block, offset = edge_cases.window_cases()[case]
    im = edge_cases.at_offset(img, offset, cuda)
    y, x = torch.from_numpy(ys).to(cuda), torch.from_numpy(xs).to(cuda)
    ck.reset_launch_counts()
    out = ck.patch_windows(im, y, x, rows, shifted, block)
    assert ck.LAUNCHES["patch_windows"] == 1
    assert torch.equal(out, ck.patch_windows_plain(im, y, x, rows, shifted, block)), label


API_ROUTES = {  # the two-step API and the nms switch: (call, launches on the card)
    "compute_orientations": (lambda o, img, blur, kps, valid, theta: o.compute_orientations(blur, kps, valid),
                             {"extract_patches": 1}),
    "brief_describe gather": (lambda o, img, blur, kps, valid, theta: o.brief_describe(blur, kps, theta, valid,
                                                                                      method="gather"), {}),
    "brief_describe mxu": (lambda o, img, blur, kps, valid, theta: o.brief_describe(blur, kps, theta, valid,
                                                                                   method="mxu"),
                           {"extract_patches": 1}),
    "extract_patches": (lambda o, img, blur, kps, valid, theta: o.brief.extract_patches(torch.stack([blur] * 3, -1),
                                                                                         kps),
                        {"extract_patches": 1}),
    "fast_detect nms=False": (lambda o, img, blur, kps, valid, theta: o.fast_detect(img, 12.0, 512, 19, nms=False),
                              {"fast_scores_nms": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(API_ROUTES))
def test_api_routes_on_the_card_equal_the_cpu(cuda, frames, route):
    """Each route of the reference's two-step API and of nms=False on the
    card equals the CPU on the same inputs, with its launches."""
    from vision_slam_frontend_tpu_torch import ops

    call, launches = API_ROUTES[route]
    img = torch.from_numpy(_u8(frames[0].left))
    blur = gaussian_blur(img.float(), sigma=2.0)
    kps, _, valid = ops.fast_detect(img, 12.0, 512, 19)
    kps = torch.cat([kps, torch.tensor([[3.4, 100.0], [636.2, 50.0], [300.0, 476.6], [-5.0, 700.0]])])
    valid = torch.cat([valid, torch.ones(4, dtype=torch.bool)])
    theta = ops.compute_orientations(blur, kps, valid)
    inputs = (img, blur, kps, valid, theta)
    want = call(ops, *inputs)
    ck.reset_launch_counts()
    got = call(ops, *(t.to(cuda) for t in inputs))
    assert ck.LAUNCHES == {k: launches.get(k, 0) for k in ck.LAUNCHES}
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        if route == "compute_orientations" or (route.startswith("fast") and b.is_floating_point()):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)  # sub-pixel fits and angles
        else:
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [{}, {"descriptor_family": "brisk"}, {"descriptor_family": "freak"},
                                       {"descriptor_family": "akaze"}, {"num_levels": 3},
                                       {"descriptor_family": "sift"}],
                         ids=["orb", "brisk", "freak", "akaze", "orb_pyramid", "sift"])
def test_keyframe_step_cuda_matches_cpu(cuda, frames, overrides):
    """From the same state, every int and bool field of the step's result
    and new state is equal on the card and on the CPU."""
    config = _config(**overrides)
    params = {d: tkf.StepParams.from_config(config, d) for d in (CPU, cuda)}
    family = get_family(config.descriptor_family)
    state = tkf.WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, CPU,
                                   words=family.words, desc_dtype=descriptor_dtype(family))
    q0_inv = np_geom.quat_inverse(np_geom.quat_normalize(frames[0].odom_rotation))
    for k in range(1, NUM_FRAMES):
        f = frames[k]
        pose_t = np_geom.quat_rotate(q0_inv, f.odom_translation - frames[0].odom_translation)
        pose_q = np_geom.quat_multiply(np_geom.quat_normalize(f.odom_rotation), q0_inv)
        out = {}
        for d in (CPU, cuda):
            s = tkf.WindowState(**{n.name: getattr(state, n.name).to(d) for n in dataclasses.fields(state)})
            t = lambda a: torch.from_numpy(np.asarray(a)).to(d)
            out[d] = tkf.keyframe_step(
                params[d], s, t(_u8(f.left)), t(_u8(f.right)), k - 1,
                num_levels=config.num_levels, descriptor_family=config.descriptor_family,
                curr_pose_t=t(pose_t.astype(np.float32)), curr_pose_q=t(pose_q.astype(np.float32)),
            )
        for obj_cpu, obj_gpu in zip(out[CPU], out[cuda]):
            for n in dataclasses.fields(obj_cpu):
                a, b = getattr(obj_gpu, n.name).cpu(), getattr(obj_cpu, n.name)
                if not b.dtype.is_floating_point:
                    assert torch.equal(a, b), (k, n.name)
        state = out[CPU][0]
    assert int(out[CPU][1].window_matched.sum()) > 10


@pytest.mark.cuda
def test_frontend_on_the_card_launches_each_kernel_twice_per_keyframe(cuda, frames):
    """Each kernel runs twice a keyframe: launched on the stream by the
    first (eager) keyframe, from the step's CUDA graph on every later one,
    counted from the graph's recorded kernels at each replay."""
    fe = Frontend(_config(), device=cuda)
    ck.reset_launch_counts()
    for f in frames:
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    n = fe.get_num_poses()
    assert n == NUM_FRAMES - 1
    assert ck.runs() == {"fast_scores_nms": 2 * n, "extract_patches": 2 * n, "hamming_top2": 2 * n,
                         "patch_windows": 0}
    assert ck.LAUNCHES["fast_scores_nms"] == 2 and ck.REPLAYED["fast_scores_nms"] == 2 * (n - 1)
    ref = Frontend(_config(), device=CPU)
    for f in frames:
        ref.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        ref.observe_image(f.left, f.right, f.timestamp)
    assert fe.get_slam_problem().summary() == ref.get_slam_problem().summary()
    for a, b in zip(fe.node_track_ids, ref.node_track_ids):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_the_span_recorder_adds_no_sync_and_no_launch(cuda, frames, monkeypatch):
    """An ORB Frontend run on the card under sync-debug "warn" gives as many
    synchronisation warnings with the span recorder on as with it off (and
    as with no profiler at all), and the profiler counts as many
    kernel-launch calls either way: the first keyframe's eager launches, the
    second's captured ones, and one graph launch for each keyframe from the
    second on; off, nothing is recorded."""
    import types
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.utils import profiling

    def run():
        fe = Frontend(_config(), device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for f in frames:
                    fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
                    fe.observe_image(f.left, f.right, f.timestamp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fe.get_num_poses() == NUM_FRAMES - 1
        return sum("synchroniz" in str(w.message) for w in caught)

    run()  # warm: kernel builds, library handles
    plain_syncs = run()
    counts = {}
    for record in (False, True):
        if not record:  # the profiler records, the recorder does not
            monkeypatch.setattr(profiling, "_autograd_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            syncs = run()
            torch.cuda.synchronize()
        monkeypatch.undo()
        launches = sum(e.count for e in prof.key_averages() if "Launch" in e.key)
        replays = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch")
        counts[record] = (syncs, launches, len(profiling.recorded_spans()), replays)
    profiling.clear_spans()
    assert counts[False][:2] == counts[True][:2] and counts[True][0] == plain_syncs
    assert counts[True][1] > 2 * 1000 and counts[True][3] == counts[False][3] == NUM_FRAMES - 2
    # About 20 spans for each eager or captured keyframe, 8 for a replayed one.
    assert counts[False][2] == 0 and counts[True][2] >= 2 * 15 + 7 * (NUM_FRAMES - 3)


@pytest.mark.cuda
def test_l2_knn_at_the_window_shape_card_matches_cpu(cuda):
    """The sift window match's kNN(2) (W*K = 5120 queries, 512 trains, 128
    floats; float64 products rounded once): the same indices, and distances
    within one float32 rounding, on the card and on the CPU."""
    from vision_slam_frontend_tpu_torch.ops.hamming import _l2_knn2

    rng = np.random.default_rng(7)
    t = np.abs(rng.normal(size=(512, 128))).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    q = t[rng.integers(0, 512, 5120)] + rng.normal(0, 0.02, (5120, 128)).astype(np.float32)
    q = (np.abs(q) / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    v = rng.random(512) > 0.1
    out = {d: _l2_knn2(*(torch.from_numpy(a).to(d) for a in (q, t, v))) for d in (CPU, cuda)}
    assert torch.equal(out[cuda][0].cpu(), out[CPU][0])
    for i in (1, 2):
        torch.testing.assert_close(out[cuda][i].cpu(), out[CPU][i], rtol=1.2e-7, atol=0)


@pytest.mark.cuda
def test_sift_path_ignores_tf32(cuda, frames):
    """SIFT's products (the histogram contraction, the moments, the L2 cross
    term) are float64, which no TF32 setting reaches: with TF32 allowed for
    matmuls and cuDNN the extractor and the L2 kNN give the same bits."""
    from vision_slam_frontend_tpu_torch.ops.hamming import _l2_knn2
    from vision_slam_frontend_tpu_torch.ops.sift import detect_and_describe_sift

    img = torch.from_numpy(_u8(frames[1].left)).to(cuda)
    out = {}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            kps, scores, desc, valid = detect_and_describe_sift(img, threshold=12.0)
            out[tf32] = (kps, scores, desc, valid, *_l2_knn2(desc, desc.flip(0), valid))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    assert int(out[False][3].sum()) > 100


def _problem_arrays(fe):
    from vision_slam_frontend_tpu_torch.io.serialize import problem_to_arrays

    return problem_to_arrays(fe.get_slam_problem(), fe.node_track_ids)


def _assert_same_problem(a, b):
    """Integer arrays equal, pixels within 1e-4 px, poses within 1e-6, points
    within 1e-3 (tests/test_checkpoint.py's tolerances)."""
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["feat_pixel"], b["feat_pixel"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(a["nodes_loc"], b["nodes_loc"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(a["feat_point3d"], b["feat_point3d"], rtol=0, atol=1e-3)


def _feed(fe, frames, after=-float("inf")):
    for f in frames:
        if f.timestamp > after:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
    return fe


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["orb", "sift"])
def test_checkpoint_saved_on_the_card_resumes_on_the_cpu(cuda, family, tmp_path):
    frames = list(generate_sequence(num_frames=8, rig=SyntheticRig()))
    config = _config(descriptor_family=family, max_features=256, frame_life=4)
    card = _feed(Frontend(config, device=cuda), frames[:4])
    ckpt = str(tmp_path / "card.ckpt.npz")
    card.save_checkpoint(ckpt)
    _feed(card, frames[4:])
    cpu = Frontend(config, device=CPU)
    _feed(cpu, frames, after=cpu.load_checkpoint(ckpt))
    assert cpu.get_num_poses() == card.get_num_poses() == 7
    _assert_same_problem(_problem_arrays(cpu), _problem_arrays(card))


@pytest.mark.cuda
def test_validate_on_the_card(cuda, frames):
    """validate=True on the card checks every keyframe, raises nothing, and
    gives the unvalidated card run's problem."""
    checked = _feed(Frontend(_config(validate=True), device=cuda), frames)
    plain = _feed(Frontend(_config(), device=cuda), frames)
    assert checked.get_num_poses() == NUM_FRAMES - 1
    _assert_same_problem(_problem_arrays(checked), _problem_arrays(plain))


# --- the keyframe step as a CUDA graph ----------------------------------------
# tests/test_golden_loop.py's sequence and Frontend settings.
GOLDEN_RIG = dict(width=512, height=384, cx=256.0, cy=192.0, fx=420.0, fy=420.0)
GOLDEN_SEQUENCE = dict(num_frames=215, step=0.25, yaw_rate=2 * np.pi / 210, odom_drift=0.02, seed=5,
                       texture_noise=2.0)
GOLDEN_CONFIG = dict(max_features=256, frame_life=8, fast_threshold=12.0)
FAMILIES = ["orb", "brisk", "freak", "akaze", "sift"]


@pytest.fixture(scope="module")
def golden():
    rig = SyntheticRig(**GOLDEN_RIG)
    return list(generate_sequence(rig=rig, **GOLDEN_SEQUENCE)), rig


def _eager_on_the_card(monkeypatch):
    """From here on every CUDA Frontend steps eagerly (the step its graphs
    would capture, on the same static inputs): the reference run."""
    from vision_slam_frontend_tpu_torch.utils.cuda_graph import CapturedCall

    monkeypatch.setattr(CapturedCall, "__call__", lambda self, fn, request: fn())


def _assert_bit_equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in b:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _window(fe) -> dict:
    return {f.name: getattr(fe._state, f.name).cpu().numpy() for f in dataclasses.fields(fe._state)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_graph_replay_equals_the_eager_step_over_the_golden_loop(cuda, golden, family, monkeypatch):
    """The golden loop through a Frontend that replays its step's graph and
    through one that steps eagerly: the problem's arrays (pixels, points,
    track ids, matches, poses), the per-keyframe stats and the final window,
    every field bit for bit."""
    frames, rig = golden
    config = FrontendConfig(calib=rig.calib(), descriptor_family=family, **GOLDEN_CONFIG)
    ck.reset_launch_counts()
    graphed = _feed(Frontend(config, device=cuda), frames)
    assert len(graphed._graphs) == 1 and next(iter(graphed._graphs.values())).call.graph is not None
    assert sum(ck.REPLAYED.values()) > 0
    _eager_on_the_card(monkeypatch)
    eager = _feed(Frontend(config, device=cuda), frames)
    assert not any(g.call.graph for g in eager._graphs.values())
    assert graphed.get_num_poses() == eager.get_num_poses() >= GOLDEN_SEQUENCE["num_frames"] - 5
    _assert_bit_equal(_problem_arrays(graphed), _problem_arrays(eager), "problem")
    assert graphed.stats == eager.stats
    _assert_bit_equal(_window(graphed), _window(eager), "window")


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_graph_replay_equals_the_eager_step_with_validate_and_debug_images(cuda, golden, family, monkeypatch):
    """validate=True and debug_images=True read more fields of the same
    replayed result: every field of every keyframe's result (raw pixels
    included) bit for bit, over the golden loop's first 40 frames."""
    frames, rig = golden
    config = FrontendConfig(calib=rig.calib(), descriptor_family=family, validate=True, debug_images=True,
                            **GOLDEN_CONFIG)
    graphed = _feed(Frontend(config, device=cuda), frames[:40])
    assert next(iter(graphed._graphs.values())).call.graph is not None
    _eager_on_the_card(monkeypatch)
    eager = _feed(Frontend(config, device=cuda), frames[:40])
    a, b = graphed.get_debug_data(), eager.get_debug_data()
    assert len(a) == len(b) == 39
    for x, y in zip(a, b):
        fields = [f.name for f in dataclasses.fields(x["result"]) if getattr(y["result"], f.name) is not None]
        assert len(fields) == 13
        _assert_bit_equal({n: getattr(x["result"], n) for n in fields}, {n: getattr(y["result"], n) for n in fields},
                          f"keyframe {x['frame_id']}")
    _assert_bit_equal(_problem_arrays(graphed), _problem_arrays(eager), "problem")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["orb", "sift"])
def test_a_run_resumed_from_a_checkpoint_equals_one_uninterrupted(cuda, family, tmp_path):
    """Saved at keyframe 4 and resumed in a new Frontend, or loaded back
    into the saving Frontend (its graph captured) after it ran on: both
    give the uninterrupted run's problem and window bit for bit."""
    frames = list(generate_sequence(num_frames=10, rig=SyntheticRig()))
    config = _config(descriptor_family=family, max_features=256, frame_life=4)
    whole = _feed(Frontend(config, device=cuda), frames)
    saving = _feed(Frontend(config, device=cuda), frames[:5])
    ckpt = str(tmp_path / "run.ckpt.npz")
    saving.save_checkpoint(ckpt)
    fresh = Frontend(config, device=cuda)
    _feed(fresh, frames, after=fresh.load_checkpoint(ckpt))
    _feed(saving, frames[5:8])
    _feed(saving, frames, after=saving.load_checkpoint(ckpt))
    assert whole.get_num_poses() == fresh.get_num_poses() == saving.get_num_poses() == 9
    for resumed in (fresh, saving):
        assert next(iter(resumed._graphs.values())).call.graph is not None
        _assert_bit_equal(_problem_arrays(resumed), _problem_arrays(whole), "problem")
        _assert_bit_equal(_window(resumed), _window(whole), "window")


@pytest.mark.cuda
def test_the_graph_adds_no_sync(cuda, frames, monkeypatch):
    """Under sync-debug "warn", a Frontend run that captures and replays its
    step warns no more often than one that steps eagerly (after a warm-up
    run that builds the kernels)."""
    import warnings

    def syncs():
        fe = Frontend(_config(), device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _feed(fe, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert fe.get_num_poses() == NUM_FRAMES - 1
        return sum("synchroniz" in str(w.message) for w in caught)

    syncs()
    graphed = syncs()
    _eager_on_the_card(monkeypatch)
    assert graphed <= syncs()


# --- the BA backend -----------------------------------------------------------
# The solver runs where its problem's tensors live; the tests below that take
# a `where` parameter run on the CPU here too (the cuda case skips).

WHERE = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(where, request):
    return request.getfixturevalue("cuda") if where == "cuda" else CPU


@pytest.mark.parametrize("where", WHERE)
def test_failed_cholesky_escalates_lambda(where, request, monkeypatch, tmp_path):
    """An indefinite S fails the Cholesky; the step is then NaN, the
    candidate cost non-finite, and LM raises lambda by lambda_up**3, as the
    JAX package does (its Cholesky returns NaN on failure)."""
    from vision_slam_frontend_tpu_torch.backend import ba
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem

    dev = _device(where, request)
    S4 = -torch.eye(6, device=dev).repeat(2, 2, 1, 1)
    d_pose, rr = ba._dense_solve_core(S4, torch.ones(2, 6, device=dev), torch.tensor([0.0, 1.0], device=dev))
    assert bool(torch.isnan(d_pose).all()) and bool(torch.isnan(rr))

    cam, problem, _, _ = synthetic_ba_problem(P=16, L=512, stereo=True, device=dev)
    solver = ba.BASolverConfig(max_iterations=1, schur_solver="dense")
    ckpt = str(tmp_path / "ok.npz")
    _, info = ba.optimize(problem, cam=cam, solver=solver, checkpoint_path=ckpt, checkpoint_every=1)
    assert info["accepted"] == 1
    assert ba.load_solver_checkpoint(ckpt, device=dev)[1]["lambda"] == pytest.approx(1e-3 * 0.4)

    solve, calls = ba._dense_solve_core, []

    def indefinite(S4, b, free):
        calls.append(1)
        return solve(-S4, b, free)

    monkeypatch.setattr(ba, "_dense_solve_core", indefinite)
    ckpt = str(tmp_path / "failed.npz")
    _, info = ba.optimize(problem, cam=cam, solver=solver, checkpoint_path=ckpt, checkpoint_every=1)
    assert calls == [1] and info["accepted"] == 0 and info["history"][1] == info["history"][0]
    assert ba.load_solver_checkpoint(ckpt, device=dev)[1]["lambda"] == pytest.approx(1e-3 * 4.0**3)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_reruns_are_bit_equal_on_the_card(cuda, solver):
    """Every reduction is deterministic on the card: two runs of one problem
    give the same poses and landmarks bit for bit. (The CPU's LAPACK and
    BLAS promise no such thing.)"""
    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem

    cam, problem, _, _ = synthetic_ba_problem(P=64, L=4096, device=cuda)
    cfg = BASolverConfig(max_iterations=2, schur_solver=solver, cg_iterations=32)
    (a, ia), (b, ib) = optimize(problem, cam=cam, solver=cfg), optimize(problem, cam=cam, solver=cfg)
    assert ia["history"] == ib["history"]
    for field in ("poses_t", "poses_q", "landmarks"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_on_the_card_matches_the_cpu(cuda, solver):
    """A stereo problem, its first 3 LM iterations on each device (each
    lowers the cost by more than 1e-4; later ones by less than 1e-5, where
    rounding decides acceptance): the same accepted steps, final cost within
    1e-5 relative, poses within 1e-4 and landmarks within 1e-3 (m)."""
    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem

    runs = []
    for dev in (cuda, CPU):
        cam, problem, _, _ = synthetic_ba_problem(P=32, L=1024, stereo=True, device=dev)
        runs.append(optimize(problem, cam=cam, solver=BASolverConfig(max_iterations=3, schur_solver=solver)))
    (g, ig), (c, ic) = runs
    assert ig["accepted"] == ic["accepted"] == 3 and ig["cost"] == pytest.approx(ic["cost"], rel=1e-5)
    assert float((g.poses_t.cpu() - c.poses_t).abs().max()) < 1e-4
    assert float((g.landmarks.cpu() - c.landmarks).abs().max()) < 1e-3


def test_ba_entry_points_refuse_cuda_without_a_gpu(monkeypatch, tmp_path):
    """build_ba_problem, the BA problem generators and slam_backend default to
    the GPU and raise where there is none (checked here by hiding the card)."""
    from vision_slam_frontend_tpu_torch.backend.tracks import build_ba_problem
    from vision_slam_frontend_tpu_torch.cli import slam_backend
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem, synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.types.slam_types import (
        FeatureMatch, RobotPose, SLAMNode, SLAMProblem, VisionFactor, VisionFeature,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = [SLAMNode(i, float(i), RobotPose(np.zeros(3), np.array([1.0, 0, 0, 0])),
                      [VisionFeature(0, np.zeros(2), np.array([0.0, 0.0, 5.0]))]) for i in range(2)]
    problem = SLAMProblem(nodes=nodes, vision_factors=[VisionFactor(0, 1, [FeatureMatch(0, 0)])])
    for call in (lambda: build_ba_problem(problem), lambda: synthetic_ba_problem(P=8, L=64),
                 lambda: make_problem(8, 64, 3),
                 lambda: slam_backend.main(["--input", str(tmp_path / "p.npz"), "--output", str(tmp_path / "o.npz")])):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert build_ba_problem(problem, device="cpu").num_landmarks == 128


# --- local BA and merging -------------------------------------------------------

_LBA = {}


def _lba_session():
    """The port's Frontend on the CPU over 9 synthetic frames (K=192, W=4):
    its problem and config, built once, on first use by a test that runs."""
    if not _LBA:
        config = _config(max_features=192, frame_life=4)
        fe = Frontend(config, device=CPU)
        for f in generate_sequence(num_frames=9, step=0.25, rig=SyntheticRig()):
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
        problem = fe.get_slam_problem()
        rng = np.random.default_rng(0)
        for node in problem.nodes[-2:]:
            node.pose.loc = node.pose.loc + rng.normal(0, 0.08, 3).astype(np.float32)
        _LBA.update(config=config, problem=problem)
    import copy

    return _LBA["config"], copy.deepcopy(_LBA["problem"])


def _locs(problem):
    return np.stack([n.pose.loc for n in problem.nodes])


@pytest.mark.cuda
def test_local_ba_on_the_card_matches_the_cpu(cuda):
    """One windowed solve (6 LM iterations of 24 CG iterations) on the card
    and on the CPU: the same cost history within 1e-4 relative and poses
    within 1e-3 m (float32 PCG at small damping: the card's sums round
    differently)."""
    from vision_slam_frontend_tpu_torch.backend.local_ba import windowed_local_ba

    config, on_card = _lba_session()
    _, on_cpu = _lba_session()
    ug, ig = windowed_local_ba(on_card, config, window=6, device=cuda)
    uc, ic = windowed_local_ba(on_cpu, config, window=6, device=CPU)
    assert ug == uc == 4
    np.testing.assert_allclose(ig["history"], ic["history"], rtol=1e-4)
    np.testing.assert_allclose(_locs(on_card), _locs(on_cpu), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_pipelined_local_ba_dispatch_has_no_host_sync(cuda):
    """A steady pipelined dispatch (window build, pinned upload, the device
    solve, the asynchronous result copy) under sync-debug "error"; the flush
    waits on the solve's event outside it and gives the synchronous result."""
    from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, windowed_local_ba

    config, problem = _lba_session()
    _, sync = _lba_session()
    state = LocalBAState()
    windowed_local_ba(problem, config, window=6, pipeline=True, state=state, device=cuda)  # warm-up
    state.flush()
    _, problem = _lba_session()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        windowed_local_ba(problem, config, window=6, pipeline=True, state=state, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.in_flight
    updated, info = state.flush()
    windowed_local_ba(sync, config, window=6, device=cuda)
    assert updated == 4 and info["node_idx"] == len(problem.nodes) - 1
    np.testing.assert_array_equal(_locs(problem), _locs(sync))


@pytest.mark.cuda
def test_dropping_a_state_mid_flight_is_safe(cuda):
    """A state dropped with a solve in flight: its result is never applied
    (the caller's poses stay as they were), the pinned buffer outlives the
    copy, and a new state starts empty and solves as if nothing had run."""
    import gc

    from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, windowed_local_ba

    config, problem = _lba_session()
    before = _locs(problem)
    state = LocalBAState()
    windowed_local_ba(problem, config, window=6, pipeline=True, state=state, device=cuda)
    del state
    gc.collect()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_locs(problem), before)
    fresh = LocalBAState()
    assert fresh.flush() == (0, None)
    _, reference = _lba_session()
    windowed_local_ba(problem, config, window=6, pipeline=True, state=fresh, device=cuda)
    fresh.flush()
    windowed_local_ba(reference, config, window=6, device=cuda)
    np.testing.assert_array_equal(_locs(problem), _locs(reference))


def test_local_ba_and_merge_refuse_cuda_without_a_gpu(monkeypatch, tmp_path):
    """windowed_local_ba, merge_sessions and the slam_merge and slam_frontend
    CLIs default to the GPU and raise where there is none (checked here by
    hiding the card)."""
    from vision_slam_frontend_tpu_torch.backend.local_ba import windowed_local_ba
    from vision_slam_frontend_tpu_torch.backend.merge import merge_sessions
    from vision_slam_frontend_tpu_torch.cli import slam_frontend, slam_merge
    from vision_slam_frontend_tpu_torch.types.slam_types import (
        FeatureMatch, RobotPose, SLAMNode, SLAMProblem, VisionFactor, VisionFeature,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = [SLAMNode(i, float(i), RobotPose(np.zeros(3, np.float32), np.array([1.0, 0, 0, 0], np.float32)),
                      [VisionFeature(0, np.zeros(2), np.array([0.0, 0.0, 5.0]))]) for i in range(4)]
    factors = [VisionFactor(i, i + 1, [FeatureMatch(0, 0)]) for i in range(3)]
    problem = SLAMProblem(nodes=nodes, vision_factors=factors)
    out = str(tmp_path / "o.npz")
    for call in (lambda: windowed_local_ba(problem, _config()),
                 lambda: merge_sessions([problem, problem]),
                 lambda: slam_merge.main(["--inputs", "a.npz", "b.npz", "--output", out]),
                 lambda: slam_frontend.main(["--input", "synthetic:5", "--output", out, "--local_ba", "4"])):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            call()
    assert merge_sessions([problem, problem], device="cpu")[1]["num_poses"] == 8


@pytest.mark.cuda
def test_checkified_step_on_the_card(cuda, frames):
    """One ORB keyframe step on the card under utils/checks.checkified: no
    error and the plain step's int and bool fields; with a NaN pose an error
    naming an aten op; an out-of-range gather raises no device assert, and a
    plain step after it still runs and matches."""
    from vision_slam_frontend_tpu_torch.utils.checks import checkified

    config = _config(max_features=512, frame_life=10)

    def step(pose_t, checked):
        args = (tkf.StepParams.from_config(config, cuda),
                tkf.WindowState.create(10, 512, config.stereo_threshold_init, cuda),
                torch.from_numpy(_u8(frames[0].left)).to(cuda), torch.from_numpy(_u8(frames[0].right)).to(cuda), 0)
        kw = dict(capacity=512, window=10, curr_pose_t=torch.tensor(pose_t, device=cuda),
                  curr_pose_q=torch.tensor([1.0, 0, 0, 0], device=cuda))
        return checkified(tkf.keyframe_step, *args, **kw) if checked else tkf.keyframe_step(*args, **kw)

    def int_fields_equal(a, b):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if not x.is_floating_point():
                assert torch.equal(x, y), f.name

    err, (_, checked) = step([0.0, 0.0, 0.0], True)
    assert err.get() is None
    _, plain = step([0.0, 0.0, 0.0], False)
    int_fields_equal(checked, plain)
    err, _ = step([0.0, float("nan"), 0.0], True)
    assert err.get().startswith("nan generated by aten.")
    err, result = checkified(torch.gather, torch.arange(4.0, device=cuda), 0, torch.tensor([1, 9], device=cuda))
    assert result is None and "out-of-bounds index" in err.get()
    _, again = step([0.0, 0.0, 0.0], False)
    int_fields_equal(again, plain)
