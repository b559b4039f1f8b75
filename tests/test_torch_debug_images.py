"""The port's debug images (viz/debug_images.py) and the frontend's debug
path (`FrontendConfig(debug_images=True)`, `debug_sink`, `get_debug_data`)
against the JAX package's: every drawing function byte-equal on the same
seeded arrays, `render_debug_entry` byte-equal on the JAX package's own
keyframe results, and both packages' frontends over the same 5 synthetic
frames (K=192, W=4) giving as many entries, each image at least 99.9%
pixel-equal (a sub-pixel coordinate at .5 may round apart).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.frontend import Frontend as JaxFrontend  # noqa: E402
from vision_slam_frontend_tpu.frontend import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.viz import debug_images as jdbg  # noqa: E402
from vision_slam_frontend_tpu.viz import live as jlive  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.viz import debug_images as tdbg  # noqa: E402
from vision_slam_frontend_tpu_torch.viz import live as tlive  # noqa: E402

FRAMES = 5
KW = dict(max_features=192, frame_life=4, fast_threshold=12.0, debug_images=True)
MIN_EQUAL = 0.999


def _points(rng, n, w, h):
    return np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)], -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drawing_functions_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    h, w = 60 + 10 * seed, 80 + 7 * seed
    img = rng.uniform(-20, 275, (h, w)).astype(np.float32)  # clipped on the way
    right = rng.integers(0, 256, (h - 5 * seed, w)).astype(np.uint8)  # another height: the canvas pads
    lp, rp = _points(rng, 12, w, h), _points(rng, 12, w, h)
    lp[0] = [10.5, 20.5]  # coordinates at .5 round half to even in both
    assert np.array_equal(tdbg._to_rgb(img), jdbg._to_rgb(img))
    for i in range(20):
        assert tdbg._line_color(i) == jdbg._line_color(i)
    canvases = [np.zeros((h, w, 3), np.uint8) for _ in range(2)]
    for mod, c in zip((tdbg, jdbg), canvases):
        for a, b in zip(lp, rp):
            mod._draw_line(c, a, b, (1, 2, 3))
            mod._draw_circle(c, a, 5, (4, 5, 6))
    assert np.array_equal(*canvases)
    assert np.array_equal(tdbg.create_stereo_debug_image(img, right, lp, rp),
                          jdbg.create_stereo_debug_image(img, right, lp, rp))
    assert np.array_equal(tdbg.create_match_debug_image(img, lp, rp), jdbg.create_match_debug_image(img, lp, rp))


def _feed(frontend, tensors=False):
    for f in generate_sequence(num_frames=FRAMES, step=0.25, rig=SyntheticRig()):
        frontend.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        left, right = f.left, f.right
        if tensors:
            left, right = (torch.from_numpy(np.clip(im, 0, 255).astype(np.uint8)) for im in (left, right))
        frontend.observe_image(left, right, f.timestamp)
    return frontend


@pytest.fixture(scope="module")
def runs():
    theirs = _feed(JaxFrontend(JaxConfig(calib=SyntheticRig().calib(), **KW)))
    ours = _feed(Frontend(FrontendConfig(calib=SyntheticRig().calib(), **KW), device="cpu"))
    return ours, theirs


def _rendered(mod, frontend):
    nodes = {n.node_idx: n for n in frontend.get_slam_problem().nodes}
    return [mod.render_debug_entry(e, nodes) for e in frontend.get_debug_data()]


def _share_equal(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).all(-1).mean())


def test_render_debug_entry_equals_the_jax_packages_on_its_results(runs):
    _, theirs = runs
    ours, ref = _rendered(tdbg, theirs), _rendered(jdbg, theirs)
    assert len(ours) == FRAMES - 1
    for (s1, m1), (s2, m2) in zip(ours, ref):
        assert np.array_equal(s1, s2)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            assert np.array_equal(m1, m2)
    assert sum(m is not None for _, m in ours) >= FRAMES - 2


def test_frontend_debug_entries_equal_the_jax_packages(runs):
    ours, theirs = runs
    a, b = ours.get_debug_data(), theirs.get_debug_data()
    assert [e["frame_id"] for e in a] == [e["frame_id"] for e in b] == list(range(FRAMES - 1))
    assert ours.get_last_debug_data() is a[-1]
    for ea, eb in zip(a, b):
        assert np.array_equal(ea["left_image"], eb["left_image"])
        assert np.array_equal(ea["right_image"], eb["right_image"])
    shares = []
    for (s1, m1), (s2, m2) in zip(_rendered(tdbg, ours), _rendered(jdbg, theirs)):
        shares.append(_share_equal(s1, s2))
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            shares.append(_share_equal(m1, m2))
    assert min(shares) >= MIN_EQUAL, shares
    match_images, stereo_images = tdbg.debug_images_from_frontend(ours)
    assert len(stereo_images) == FRAMES - 1
    assert len(match_images) == sum(m is not None for _, m in _rendered(tdbg, ours))


def test_streamer_writes_the_jax_packages_file_names(runs, tmp_path):
    ours, theirs = runs
    names = {}
    for tag, mod, frontend in (("ours", tlive, ours), ("theirs", jlive, theirs)):
        sink = mod.DebugImageStreamer(str(tmp_path / tag))
        for entry in frontend.get_debug_data():
            sink(entry, frontend)
        names[tag] = sorted(p.name for p in (tmp_path / tag).iterdir())
        assert sink.num_stereo == FRAMES - 1 and sink.last_path.endswith(".png")
    assert names["ours"] == names["theirs"]
    assert any(n.startswith("match_") for n in names["ours"])


def test_device_tensor_images_are_drawn_as_the_arrays_are(runs):
    """uint8 tensors handed to observe_image reach the debug entry through
    the pending slot, equal to the clipped arrays."""
    ours, _ = runs
    fe = _feed(Frontend(FrontendConfig(calib=SyntheticRig().calib(), **KW), device="cpu"), tensors=True)
    for ea, eb in zip(fe.get_debug_data(), ours.get_debug_data()):
        assert isinstance(ea["left_image"], np.ndarray) and ea["left_image"].dtype == np.uint8
        assert np.array_equal(ea["left_image"], np.clip(eb["left_image"], 0, 255).astype(np.uint8))
        assert np.array_equal(ea["result"].pixels_raw, eb["result"].pixels_raw)
    assert fe.get_config() is fe.config


def test_debug_images_change_nothing_in_the_problem(runs):
    ours, _ = runs
    plain = _feed(Frontend(FrontendConfig(calib=SyntheticRig().calib(), **dict(KW, debug_images=False)),
                           device="cpu"))
    assert plain.get_debug_data() == []
    a, b = ours.get_slam_problem(), plain.get_slam_problem()
    assert a.summary() == b.summary()
    for na, nb in zip(a.nodes, b.nodes):
        assert np.array_equal(np.array([f.pixel for f in na.features]), np.array([f.pixel for f in nb.features]))
