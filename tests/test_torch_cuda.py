"""The port on a CUDA GPU: each kernel against its plain PyTorch version at
the main paths' shapes, and the keyframe step and Frontend on the card
against the CPU, for every descriptor family and the ORB pyramid.

Every test here needs the card and skips where there is none. The file
imports no JAX (the GPU machine has none), so it runs there on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Kernel outputs are integers (FAST scores, Hamming distances, indices) or
copies (patches), so every comparison is exact.
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
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [{}, {"descriptor_family": "brisk"}, {"descriptor_family": "freak"},
                                       {"descriptor_family": "akaze"}, {"num_levels": 3}],
                         ids=["orb", "brisk", "freak", "akaze", "orb_pyramid"])
def test_keyframe_step_cuda_matches_cpu(cuda, frames, overrides):
    """From the same state, every int and bool field of the step's result
    and new state is equal on the card and on the CPU."""
    config = _config(**overrides)
    params = {d: tkf.StepParams.from_config(config, d) for d in (CPU, cuda)}
    state = tkf.WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, CPU,
                                   words=get_family(config.descriptor_family).words)
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
    fe = Frontend(_config(), device=cuda)
    ck.reset_launch_counts()
    for f in frames:
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    n = fe.get_num_poses()
    assert n == NUM_FRAMES - 1
    assert ck.LAUNCHES == {"fast_scores_nms": 2 * n, "extract_patches": 2 * n, "hamming_top2": 2 * n,
                           "patch_windows": 0}
    ref = Frontend(_config(), device=CPU)
    for f in frames:
        ref.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        ref.observe_image(f.left, f.right, f.timestamp)
    assert fe.get_slam_problem().summary() == ref.get_slam_problem().summary()
    for a, b in zip(fe.node_track_ids, ref.node_track_ids):
        np.testing.assert_array_equal(a, b)
