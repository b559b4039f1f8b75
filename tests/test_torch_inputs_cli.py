"""The port's frontend CLI on real inputs against the JAX package's CLI, on
the CPU: a synthetic ROS bag (8 frames), a KITTI sequence and an EuRoC
directory (5 frames each, written as tests/test_io.py writes them), with --config, --output_bag, --ply and --html,
then bag_extract; the decode-ahead thread; and chip_smoke's copies of the
golden-bag pins and the adversarial conditions.

Both packages decode on one route here (cv2: the JAX package's native
library is a gitignored build that a checkout may lack, and two JPEG
decoders may round an IDCT differently). Problems: keyframe counts, every
int field and the track ids equal, poses within 1e-6, feature pixels within
1e-3 px; exported landmarks within 1% (the reference's float32
triangulation).
"""

import contextlib
import io
import json
import os
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests import test_adversarial_conditions, test_golden_bag  # noqa: E402
from tests.test_io import CLI_ARGS, write_synthetic_bag  # noqa: E402
from vision_slam_frontend_tpu.cli import bag_extract as jax_extract  # noqa: E402
from vision_slam_frontend_tpu.cli import slam_frontend as jax_cli  # noqa: E402
from vision_slam_frontend_tpu.io import native_loader as jax_native  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.cli import bag_extract  # noqa: E402
from vision_slam_frontend_tpu_torch.cli import slam_frontend as cli  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io import native_loader, rosbag  # noqa: E402
from vision_slam_frontend_tpu_torch.io.euroc import write_directory  # noqa: E402
from vision_slam_frontend_tpu_torch.io.kitti import write_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.io.ros_msgs import deserialize_slam_problem  # noqa: E402

INPUTS = ["bag", "kitti", "euroc"]


@contextlib.contextmanager
def _cv2_route():
    """Both packages decode with cv2 and read bags with the Python reader."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "native_available", lambda: False)
        mp.setattr(native_loader, "native_available", lambda: False)
        yield


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The three inputs and a config the port saved, for the bag."""
    tmp = tmp_path_factory.mktemp("inputs")
    rig = SyntheticRig()
    frames = list(generate_sequence(num_frames=5, step=0.25, rig=rig))
    write_synthetic_bag(str(tmp / "seq.bag"), num_frames=8)
    write_sequence(str(tmp / "05"), frames, rig)
    write_directory(str(tmp / "euroc"), frames, rig)
    FrontendConfig(calib=rig.calib(), fast_threshold=12.0).save(str(tmp / "rig.yaml"))
    return {"tmp": str(tmp), "bag": ["--input", str(tmp / "seq.bag"), "--config", str(tmp / "rig.yaml")],
            "kitti": ["--input", str(tmp / "05"), "--dataset", "kitti"], "euroc": ["--input", str(tmp / "euroc")]}


@pytest.fixture(scope="module", params=INPUTS)
def runs(request, inputs):
    """Each package's CLI on one input with every export; returns
    {package: {kind: path}} and the port's printout."""
    kind = request.param
    out = {}
    printed = None
    with _cv2_route():
        for pkg, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu", "-v", "1"])):
            base = os.path.join(inputs["tmp"], f"{kind}_{pkg}")
            paths = {"npz": base + ".npz", "bag": base + "_out.bag", "ply": base + ".ply", "html": base + ".html"}
            rc, text = _run(main, inputs[kind] + ["--output", paths["npz"], "--output_bag", paths["bag"],
                                                  "--ply", paths["ply"], "--html", paths["html"]] + CLI_ARGS + extra)
            assert rc == 0, text
            out[pkg] = paths
            printed = text
    return kind, out, printed


def test_problems_equal_the_jax_clis(runs):
    kind, out, printed = runs
    assert "[decode] cv2" in printed
    assert ("Done processing bag file." if kind == "bag" else "Done processing input.") in printed
    with np.load(out["jax"]["npz"]) as r, np.load(out["port"]["npz"]) as p:
        assert sorted(p.files) == sorted(r.files)
        assert len(p["nodes_id"]) == (7 if kind == "bag" else 4)
        assert np.bincount(p["feat_node"]).min() > 20
        for k in r.files:
            assert (p[k].shape, p[k].dtype) == (r[k].shape, r[k].dtype), k
            if r[k].dtype.kind in "iub":
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        for k in ("nodes_loc", "nodes_quat", "of_translation", "of_rotation"):
            np.testing.assert_allclose(p[k], r[k], atol=1e-6, err_msg=k)
        for k in ("feat_pixel", "feat_pixel_right"):
            np.testing.assert_allclose(p[k], r[k], atol=1e-3, err_msg=k)


def test_exports_equal_the_jax_clis(runs):
    """--output_bag (read back through deserialize_slam_problem and held to
    the npz), --ply and --html against the JAX CLI's."""
    _, out, _ = runs
    bags = {pkg: list(rosbag.read_messages(out[pkg]["bag"], raw=True)) for pkg in out}
    assert [m[:2] for m in bags["port"]] == [m[:2] for m in bags["jax"]]
    assert [m[0] for m in bags["port"]] == ["extrinsics", "intrinsics", "slam_problem"]
    assert [m[2]["raw"] for m in bags["port"][:2]] == [m[2]["raw"] for m in bags["jax"][:2]]
    ours, theirs = (deserialize_slam_problem(bags[pkg][2][2]["raw"]) for pkg in ("port", "jax"))
    with np.load(out["port"]["npz"]) as p:
        assert [n.node_idx for n in ours.nodes] == [n.node_idx for n in theirs.nodes] == list(p["nodes_id"])
        np.testing.assert_array_equal(np.concatenate([[f.feature_idx for f in n.features] for n in ours.nodes]),
                                      p["feat_idx"])
        np.testing.assert_allclose(np.stack([n.pose.loc for n in ours.nodes]), p["nodes_loc"], atol=1e-7)
    for a, b in zip(ours.nodes, theirs.nodes):
        np.testing.assert_allclose(np.stack([f.pixel for f in a.features]), np.stack([f.pixel for f in b.features]),
                                   atol=1e-3)
    assert [[(m.feature_idx_initial, m.feature_idx_current) for m in v.feature_matches] for v in ours.vision_factors] \
        == [[(m.feature_idx_initial, m.feature_idx_current) for m in v.feature_matches] for v in theirs.vision_factors]

    heads, bodies = {}, {}
    for pkg in out:
        data = open(out[pkg]["ply"], "rb").read()
        end = data.index(b"end_header\n") + len(b"end_header\n")
        heads[pkg], bodies[pkg] = data[:end], data[end:]
    assert heads["port"] == heads["jax"]
    n_vert = int(re.search(rb"element vertex (\d+)", heads["port"]).group(1))
    rec = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vp, vj = (np.frombuffer(bodies[pkg][: n_vert * rec.itemsize], rec) for pkg in ("port", "jax"))
    np.testing.assert_array_equal(vp["rgb"], vj["rgb"])
    n_nodes = len(ours.nodes)
    np.testing.assert_allclose(vp["xyz"][:n_nodes], vj["xyz"][:n_nodes], atol=1e-6)
    # Landmarks: the reference triangulates with float32 normal equations,
    # up to 1.7e-3 relative off the exact solve the port takes (ROADMAP C).
    np.testing.assert_allclose(vp["xyz"][n_nodes:], vj["xyz"][n_nodes:], rtol=1e-2, atol=1e-3)
    assert bodies["port"][n_vert * rec.itemsize:] == bodies["jax"][n_vert * rec.itemsize:]  # the edges

    def viewer_data(path):
        return json.loads(re.search(r"const DATA = (\{.*?\});\n", open(path).read()).group(1))

    dp, dj = viewer_data(out["port"]["html"]), viewer_data(out["jax"]["html"])
    assert (dp["odom_edges"], dp["vision_edges"]) == (dj["odom_edges"], dj["vision_edges"])
    np.testing.assert_allclose(dp["nodes"], dj["nodes"], atol=1e-4)
    assert len(dp["landmarks"]) == len(dj["landmarks"])


def test_bag_extract_equals_the_jax_tools(inputs):
    bag = inputs["bag"][1]
    dirs = [os.path.join(inputs["tmp"], f"extract_{pkg}") for pkg in ("port", "jax")]
    with _cv2_route():
        for main, d in zip((bag_extract.main, jax_extract.main), dirs):
            rc, text = _run(main, ["--input", bag, "--output_dir", d, "--max_images", "3",
                                   "--image_topic", "/stereo/right/image_raw/compressed"])
            assert rc == 0 and "Extracted 3 images" in text
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == ["000000.jpg", "000001.jpg", "000002.jpg"]
    for name in os.listdir(dirs[0]):
        assert open(os.path.join(dirs[0], name), "rb").read() == open(os.path.join(dirs[1], name), "rb").read()


def test_bag_on_the_native_route_and_without_prefetch(inputs, monkeypatch):
    """The port's own default route here: the native scanner and decoder
    where libjpeg is present (else cv2, and -v 1 says why); the same problem
    with --no_prefetch and with VSF_DISABLE_NATIVE=1 (Python reader, the
    same decoder)."""
    tmp = inputs["tmp"]
    argv = inputs["bag"] + CLI_ARGS + ["--device", "cpu", "-v", "1"]
    rc, printed = _run(cli.main, argv + ["--output", os.path.join(tmp, "native.npz")])
    assert rc == 0
    if native_loader.native_available():
        assert "[decode] native libjpeg" in printed and "[native] C++ bag scanner: 24 records" in printed
    else:
        assert f"native libjpeg unavailable: {native_loader.unavailable_reason()}" in printed
    rc, _ = _run(cli.main, argv + ["--output", os.path.join(tmp, "no_prefetch.npz"), "--no_prefetch"])
    assert rc == 0
    monkeypatch.setenv("VSF_DISABLE_NATIVE", "1")
    rc, printed = _run(cli.main, argv + ["--output", os.path.join(tmp, "python_reader.npz")])
    assert rc == 0 and "[native]" not in printed
    with np.load(os.path.join(tmp, "native.npz")) as a:
        assert len(a["nodes_id"]) == 7
        for other in ("no_prefetch.npz", "python_reader.npz"):
            with np.load(os.path.join(tmp, other)) as b:
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{other} {k}")


def test_port_flags_work_on_a_bag(inputs):
    """--interrupt_after (exit 130, partial problem + checkpoint), --resume
    and --validate on the bag input: the resumed run equals the plain one."""
    tmp = inputs["tmp"]
    argv = inputs["bag"] + CLI_ARGS + ["--device", "cpu"]
    full, cut, resumed = (os.path.join(tmp, f"flags_{k}.npz") for k in ("full", "cut", "resumed"))
    assert _run(cli.main, argv + ["--output", full, "--validate"])[0] == 0
    rc, printed = _run(cli.main, argv + ["--output", cut, "--interrupt_after", "3"])
    assert rc == 130 and "SIGINT" in printed and os.path.exists(cut + ".ckpt.npz")
    assert _run(cli.main, argv + ["--output", resumed, "--resume", cut + ".ckpt.npz"])[0] == 0
    with np.load(full) as a, np.load(resumed) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_unreadable_and_undetectable_inputs(tmp_path):
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"not a bag")
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
        rc, printed = _run(main, ["--input", str(bad), "--output", str(tmp_path / "o.npz")] + extra)
        assert rc == 1 and "Unable to read" in printed and "not a ROS bag" in printed
    for main in (cli.main, jax_cli.main):
        with pytest.raises(ValueError, match="Cannot auto-detect dataset type"):
            main(["--input", str(tmp_path), "--output", str(tmp_path / "o.npz")])


def _alive():
    return any(t.name == "vsf-prefetch" and t.is_alive() for t in threading.enumerate())


def test_prefetch_producer_exits_on_abandonment():
    """The consumer abandons the decode-ahead generator with the queue full:
    the producer thread exits instead of blocking on the bounded queue."""

    def src():
        for i in range(1000):
            yield ("odometry", float(i), None)

    g = cli.prefetch_events(src(), depth=2)
    assert next(g)[0] == "odometry"
    g.close()
    deadline = time.time() + 5.0
    while time.time() < deadline and _alive():
        time.sleep(0.05)
    assert not _alive(), "prefetch producer thread leaked after close()"


def test_prefetch_keeps_order_and_raises_the_producers_error():
    def src():
        for i in range(50):
            yield ("stereo", float(i), (i,))
        raise FileNotFoundError("frame 50 is missing")

    g = cli.prefetch_events(src(), depth=4)
    got = []
    with pytest.raises(FileNotFoundError, match="frame 50"):
        for item in g:
            got.append(item[1])
    assert got == [float(i) for i in range(50)]
    deadline = time.time() + 5.0
    while time.time() < deadline and _alive():
        time.sleep(0.05)
    assert not _alive()


def test_chip_smoke_copies_of_the_pins_equal_the_tests():
    """chip_smoke imports no test module; its copies of the degraded-bag
    pins and the adversarial conditions must stay equal to the tests'."""
    import chip_smoke

    assert chip_smoke.BAG_GOLDEN == test_golden_bag.FAMILY_GOLDEN
    assert (chip_smoke.BAG_FRAMES, chip_smoke.BAG_ODOM_DRIFT, chip_smoke.BAG_JPEG_QUALITY) == (
        test_golden_bag.NUM_FRAMES, test_golden_bag.ODOM_DRIFT, test_golden_bag.JPEG_QUALITY)
    assert sorted(chip_smoke.CONDITIONS) == sorted(test_adversarial_conditions.CONDITIONS)
    for name, spec in test_adversarial_conditions.CONDITIONS.items():
        assert repr(chip_smoke.CONDITIONS[name]) == repr(spec), name
    assert chip_smoke.CONDITION_FAMILIES == test_adversarial_conditions.FAMILIES
    assert chip_smoke.CONDITION_FRAMES == test_adversarial_conditions.NUM_FRAMES
