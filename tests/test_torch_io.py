"""The port's input and output modules against the JAX package's, on the same
inputs made from a seed: bags (bytes and messages), the output wire format,
the degrader, the native decoder and bag scanner, configs, the YAML reader
and the dataset calibrations. Everything here is exact: equal bytes, equal
arrays, equal dicts.
"""

import bz2
import os
import struct
import subprocess

import numpy as np
import pytest
import yaml

from tests.test_adversarial_conditions import CONDITIONS
from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig
from vision_slam_frontend_tpu.io import degrade as jdeg
from vision_slam_frontend_tpu.io import euroc as jeuroc
from vision_slam_frontend_tpu.io import image as jimage
from vision_slam_frontend_tpu.io import kitti as jkitti
from vision_slam_frontend_tpu.io import native_loader as jnative
from vision_slam_frontend_tpu.io import ros_msgs as jmsgs
from vision_slam_frontend_tpu.io import rosbag as jbag
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig as JaxRig
from vision_slam_frontend_tpu.types import slam_types as jtypes
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
from vision_slam_frontend_tpu_torch.io import degrade as tdeg
from vision_slam_frontend_tpu_torch.io import euroc as teuroc
from vision_slam_frontend_tpu_torch.io import image as timage
from vision_slam_frontend_tpu_torch.io import kitti as tkitti
from vision_slam_frontend_tpu_torch.io import native_loader as tnative
from vision_slam_frontend_tpu_torch.io import ros_msgs as tmsgs
from vision_slam_frontend_tpu_torch.io import rosbag as tbag
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig
from vision_slam_frontend_tpu_torch.types import slam_types as ttypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["orb", "brisk", "freak", "akaze", "sift"]
SMALL_RIG = dict(width=128, height=96, cx=64.0, cy=48.0, fx=105.0, fy=105.0)


def _write_bag(mod, path, seed, chunk_threshold=768 * 1024):
    """Odometry, left and right images with JPEG payloads and an unknown
    type, through one package's BagWriter."""
    rng = np.random.default_rng(seed)
    with mod.BagWriter(path, chunk_threshold=chunk_threshold) as bag:
        c_o = bag.get_connection("/odom", "nav_msgs/Odometry", "md5-odom", "definition")
        c_l = bag.get_connection("/left", "sensor_msgs/CompressedImage", "*", "")
        c_r = bag.get_connection("/right", "sensor_msgs/CompressedImage", "*", "")
        c_x = bag.get_connection("/other", "std_msgs/String", "*", "string data")
        for i in range(12):
            t_ns = 1_000_000_000 + i * 50_000_000 + int(rng.integers(0, 1000))
            q = rng.normal(size=4)
            bag.write(c_o, t_ns, mod.serialize_odometry(i, t_ns, rng.normal(size=3), q / np.linalg.norm(q)))
            for c in (c_l, c_r):
                img = rng.integers(0, 255, (24, 32), dtype=np.uint8)
                bag.write(c, t_ns, mod.serialize_compressed_image(i, t_ns, "jpeg", timage.encode_jpeg(img)))
            bag.write(c_x, t_ns + 1, struct.pack("<I", 3) + b"abc")


def _same_messages(a, b):
    assert len(a) == len(b) > 0
    for (ta, na, ma), (tb, nb, mb) in zip(a, b):
        assert (ta, na) == (tb, nb)
        assert sorted(ma) == sorted(mb)
        for k in ma:
            if isinstance(ma[k], np.ndarray):
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
            else:
                assert ma[k] == mb[k], k


# ---------------------------------------------------------------------------
# Bags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_threshold", [768 * 1024, 4096], ids=["one_chunk", "chunked"])
def test_bag_bytes_equal_the_jax_writers(tmp_path, chunk_threshold):
    ours, theirs = str(tmp_path / "port.bag"), str(tmp_path / "jax.bag")
    _write_bag(tbag, ours, 1, chunk_threshold)
    _write_bag(jbag, theirs, 1, chunk_threshold)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    assert (chunk_threshold == 4096) == (data.count(b"op=\x05") > 1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_bag(tmp_path, writer):
    path = str(tmp_path / "x.bag")
    _write_bag(tbag if writer == "port" else jbag, path, 2, chunk_threshold=4096)
    ours, theirs = list(tbag.read_messages(path)), list(jbag.read_messages(path))
    _same_messages(ours, theirs)
    assert len(ours) == 48 and ours[3][2] == {"raw": struct.pack("<I", 3) + b"abc", "type": "std_msgs/String"}
    _same_messages(list(tbag.read_messages(path, raw=True)), list(jbag.read_messages(path, raw=True)))


def _bz2_bag(mod, path, compression=b"bz2", compress=bz2.compress):
    """A bag whose one chunk is compressed (bz2 by default), built from the
    package's record helpers."""
    rec = mod.BagWriter._record
    conn_data = mod._encode_header({b"topic": b"/o", b"type": b"nav_msgs/Odometry"})
    chunk = rec({b"op": b"\x07", b"conn": struct.pack("<I", 0), b"topic": b"/o"}, conn_data)
    for i in range(3):
        chunk += rec({b"op": b"\x02", b"conn": struct.pack("<I", 0), b"time": struct.pack("<Q", 10 + i)},
                     mod.serialize_odometry(i, 10 + i, [i, 0, 0], [1, 0, 0, 0]))
    with open(path, "wb") as f:
        f.write(mod.MAGIC + rec({b"op": b"\x05", b"compression": compression,
                                 b"size": struct.pack("<I", len(chunk))}, compress(chunk)))


@pytest.mark.parametrize("case", ["topic_filter", "bad_magic", "bz2", "unknown_compression"])
def test_reader_edge_cases_behave_as_the_jax_packages(tmp_path, case):
    path = str(tmp_path / "e.bag")
    if case == "topic_filter":
        _write_bag(jbag, path, 3)
        _same_messages(list(tbag.read_messages(path, topics=["/right", "/other"])),
                       list(jbag.read_messages(path, topics=["/right", "/other"])))
        assert {t for t, _, _ in tbag.read_messages(path, topics=["/right"])} == {"/right"}
    elif case == "bad_magic":
        open(path, "wb").write(b"#ROSBAG V1.2\nxxxx")
        for mod in (tbag, jbag):
            with pytest.raises(ValueError, match="not a ROS bag v2.0 file"):
                list(mod.read_messages(path))
    elif case == "bz2":
        _bz2_bag(tbag, path)
        ours = list(tbag.read_messages(path))
        _same_messages(ours, list(jbag.read_messages(path)))
        assert [m[2]["position"][0] for m in ours] == [0.0, 1.0, 2.0]
    else:
        _bz2_bag(tbag, path, compression=b"zzz")
        for mod in (tbag, jbag):
            with pytest.raises(ValueError, match="unknown bag compression"):
                list(mod.read_messages(path))


def test_lz4_chunks_need_the_lz4_module(tmp_path):
    """Without the lz4 module both readers refuse an lz4 chunk with the same
    error; with it, both read the same messages."""
    path = str(tmp_path / "l.bag")
    try:
        import lz4.frame
    except ImportError:
        _bz2_bag(tbag, path, compression=b"lz4")
        for mod in (tbag, jbag):
            with pytest.raises(RuntimeError, match="lz4 module is unavailable"):
                list(mod.read_messages(path))
    else:
        _bz2_bag(tbag, path, compression=b"lz4", compress=lz4.frame.compress)
        _same_messages(list(tbag.read_messages(path)), list(jbag.read_messages(path)))
    assert set(tbag.DESERIALIZERS) == set(jbag.DESERIALIZERS)


# ---------------------------------------------------------------------------
# The output wire format
# ---------------------------------------------------------------------------


def _problem(types, seed):
    """A SLAMProblem of `types` from seeded numpy arrays."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(4):
        feats = [types.VisionFeature(int(rng.integers(0, 10_000)), rng.uniform(0, 640, 2).astype(np.float32),
                                     rng.normal(0, 3, 3).astype(np.float32) + np.float32([0, 0, 4]))
                 for _ in range(int(rng.integers(0, 6)))]
        q = rng.normal(size=4).astype(np.float32)
        nodes.append(types.SLAMNode(i, 0.1 * i + 1e-3, types.RobotPose(rng.normal(size=3).astype(np.float32),
                                                                       q / np.linalg.norm(q)), feats))
    vfs = [types.VisionFactor(0, 1, [types.FeatureMatch(1, 2), types.FeatureMatch(2**40, 7)]),
           types.VisionFactor(1, 3, [])]
    ofs = [types.OdometryFactor(i, i + 1, rng.normal(size=3).astype(np.float32),
                                np.float32([1, 0, 0, 0])) for i in range(3)]
    return types.SLAMProblem(nodes=nodes, vision_factors=vfs, odometry_factors=ofs)


def test_message_md5s_and_definitions_equal_the_jax_packages():
    assert tmsgs._SCHEMAS == jmsgs._SCHEMAS and tmsgs.PKG == jmsgs.PKG
    for name in jmsgs._SCHEMAS:
        assert tmsgs.msg_md5(name) == jmsgs.msg_md5(name), name
        assert tmsgs.msg_definition(name) == jmsgs.msg_definition(name), name
    assert tmsgs.msg_md5("geometry_msgs/Quaternion") == "a779879fadf0160734f906b8c19c7004"


@pytest.mark.parametrize("seed", [0, 1])
def test_serialized_problem_and_output_bag_equal_the_jax_packages(tmp_path, seed):
    ours, theirs = _problem(ttypes, seed), _problem(jtypes, seed)
    data = tmsgs.serialize_slam_problem(ours)
    assert data == jmsgs.serialize_slam_problem(theirs)
    back = tmsgs.deserialize_slam_problem(data)
    assert tmsgs.serialize_slam_problem(back) == jmsgs.serialize_slam_problem(jmsgs.deserialize_slam_problem(data))
    assert isinstance(back.nodes[0], ttypes.SLAMNode)
    rig = SyntheticRig().calib() if seed else None
    config = FrontendConfig(calib=rig) if rig else FrontendConfig()
    jconfig = JaxConfig(calib=JaxRig().calib()) if rig else JaxConfig()
    tmsgs.write_output_bag(str(tmp_path / "p.bag"), ours, config, t_ns=seed)
    jmsgs.write_output_bag(str(tmp_path / "j.bag"), theirs, jconfig, t_ns=seed)
    assert open(tmp_path / "p.bag", "rb").read() == open(tmp_path / "j.bag", "rb").read()
    np.testing.assert_array_equal(tkitti.rotmat_to_quat(config.left_cam_to_robot[:3, :3].astype(np.float64)),
                                  jkitti._rotmat_to_quat(jconfig.left_cam_to_robot[:3, :3].astype(np.float64)))


# ---------------------------------------------------------------------------
# Degradation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("condition", sorted(CONDITIONS))
def test_degrader_equals_the_jax_packages(condition):
    kw = CONDITIONS[condition]["degrader"]
    img = np.random.default_rng(len(condition)).uniform(0, 255, (40, 56)).astype(np.float32)
    ours, theirs = tdeg.Degrader(**kw), jdeg.Degrader(**kw)
    for frame in (0, 3):
        for cam in (0, 1):
            np.testing.assert_array_equal(ours(img, frame, cam=cam), theirs(img, frame, cam=cam))


def test_degraded_bag_equals_the_jax_packages(tmp_path):
    kw = dict(num_frames=3, odom_drift=0.02, jpeg_quality=88, seed=9)
    gt = tdeg.write_degraded_bag(str(tmp_path / "p.bag"), rig=SyntheticRig(**SMALL_RIG), **kw)
    jgt = jdeg.write_degraded_bag(str(tmp_path / "j.bag"), rig=JaxRig(**SMALL_RIG), **kw)
    assert list(gt) == list(jgt)
    for k in gt:
        np.testing.assert_array_equal(gt[k], jgt[k])
    assert open(tmp_path / "p.bag", "rb").read() == open(tmp_path / "j.bag", "rb").read()


# ---------------------------------------------------------------------------
# Decoding and the native library
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ctypes bindings over its own source, built with its
    Makefile's flags into a temporary directory (its prebuilt library is not
    part of a checkout); restored afterwards. Skips nothing: where the port
    finds no jpeglib.h, the test asserts the port reports it."""
    reason = tnative.unavailable_reason()
    if reason is not None:
        yield None, reason
        return
    lib = str(tmp_path_factory.mktemp("jax_native") / "vsf_native.so")
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o", lib,
                    os.path.join(REPO, "native", "vsf_native.cpp"), "-ljpeg", "-lpthread"], check=True)
    saved = jnative._lib_path, jnative._LIB
    jnative._lib_path, jnative._LIB = (lambda: lib), None
    assert jnative.native_available()
    try:
        yield jnative, None
    finally:
        jnative._lib_path, jnative._LIB = saved


def _jpegs(seed, n, shape=(48, 64), quality=90):
    rng = np.random.default_rng(seed)
    imgs = [np.clip(rng.normal(128, 60, shape), 0, 255).astype(np.uint8) for _ in range(n)]
    return imgs, [timage.encode_jpeg(im, quality=quality) for im in imgs]


def test_native_decode_equals_the_jax_native_loaders(jax_native):
    jn, reason = jax_native
    if jn is None:
        assert not tnative.native_available() and ("jpeglib.h" in reason or "compiler" in reason)
        assert timage.decode_route() in ("cv2", "PIL")
        return
    assert timage.decode_route() == "native libjpeg"
    assert tnative.library_path().is_file() and "build" in tnative.library_path().parts
    imgs, jpegs = _jpegs(4, 6)
    for data in jpegs:
        np.testing.assert_array_equal(tnative.decode_jpeg_gray(data), jn.decode_jpeg_gray(data))
    ours, s_ours = tnative.decode_jpeg_batch(jpegs + [b"not a jpeg at all"], 64, 48, num_threads=3)
    theirs, s_theirs = jn.decode_jpeg_batch(jpegs + [b"not a jpeg at all"], 64, 48, num_threads=3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(s_ours, s_theirs)
    assert (s_ours[:-1] == 0).all() and s_ours[-1] != 0 and (ours[-1] == 0).all()
    for garbage in (b"\x00\x01\x02", jpegs[0][: len(jpegs[0]) // 3] + b"\xff"):
        assert (tnative.decode_jpeg_gray(garbage) is None) == (jn.decode_jpeg_gray(garbage) is None)
    assert tnative.decode_jpeg_gray(b"\x00\x01\x02") is None
    msg = {"format": "jpeg", "data": jpegs[1]}
    np.testing.assert_array_equal(timage.decode_compressed_image(msg), jimage.decode_compressed_image(msg))


def test_native_bag_scanner_equals_the_jax_one(jax_native, tmp_path):
    jn, _ = jax_native
    path = str(tmp_path / "s.bag")
    _write_bag(jbag, path, 5, chunk_threshold=4096)
    if jn is None:
        with pytest.raises(RuntimeError, match="unavailable"):
            tnative.NativeBagReader(path)
        return
    with tnative.NativeBagReader(path) as ours:
        theirs = jn.NativeBagReader(path)
        assert len(ours) == len(theirs) == 48 and ours.connections == theirs.connections
        assert list(ours.read_messages(["/odom", "/left"])) == list(theirs.read_messages(["/odom", "/left"]))
        theirs.close()
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"garbage")
    with pytest.raises(ValueError, match="not a readable ROS bag"):
        tnative.NativeBagReader(str(bad))


def test_python_decode_and_encode_equal_the_jax_packages():
    imgs, jpegs = _jpegs(6, 2, quality=75)
    for img, data in zip(imgs, jpegs):
        assert data == jimage.encode_jpeg(img, quality=75)
        np.testing.assert_array_equal(timage.decode_image_bytes(data), jimage.decode_image_bytes(data))
    bayer = timage.encode_jpeg(np.tile(np.uint8([[200, 40], [90, 10]]), (16, 16)))
    np.testing.assert_array_equal(timage.decode_compressed_image({"format": "bayer_rggb8; jpeg", "data": bayer}),
                                  jimage.decode_compressed_image({"format": "bayer_rggb8; jpeg", "data": bayer}))


# ---------------------------------------------------------------------------
# Configs, the YAML reader, dataset calibrations
# ---------------------------------------------------------------------------


def _config_fields(c) -> dict:
    return {k: v for k, v in vars(c).items() if not isinstance(v, np.ndarray) and k not in
            ("intrinsics_left", "intrinsics_right")}


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_cross_packages(tmp_path, family):
    """A config saved by either package loads in the other, with every field
    and derived matrix equal, and the port writes the JAX package's bytes."""
    kw = dict(descriptor_family=family, max_features=256, frame_life=8, fast_threshold=12.0,
              validate=family == "sift", guided_match_radius=-1.0 if family == "akaze" else 40.0)
    jpath, tpath = str(tmp_path / "j.yaml"), str(tmp_path / "t.yaml")
    JaxConfig(calib=JaxRig(**SMALL_RIG).calib(), **kw).save(jpath)
    FrontendConfig(calib=SyntheticRig(**SMALL_RIG).calib(), **kw).save(tpath)
    assert open(tpath).read() == open(jpath).read()
    ours, theirs = FrontendConfig.load(jpath), JaxConfig.load(tpath)
    assert _config_fields(ours) == _config_fields(theirs)
    for k in ("K_left", "K_right", "P_left", "P_right", "fundamental", "left_cam_to_robot"):
        np.testing.assert_array_equal(getattr(ours, k), np.asarray(getattr(theirs, k)), err_msg=k)
    with open(tpath, "a") as f:
        f.write("not_a_field: 1\n")
    for cls in (FrontendConfig, JaxConfig):
        with pytest.raises(ValueError, match="Unknown config keys"):
            cls.load(tpath)


_SENSOR_YAML = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""

_CONFIG_FILES = {
    "unclosed_flow_list": ("frame_life: 6\nmax_features: [256, 512\n", yaml.YAMLError),
    "tab_indentation": ("calib:\n\tintrinsics_left: {}\n", yaml.YAMLError),
    "unknown_key": ("max_features: 256\nnot_a_field: 1\n", ValueError),
    "top_level_list": ("- max_features: 256\n", TypeError),
    "anchor_and_alias": ("fast_threshold: &t 12.5\nstereo_threshold_padding: *t\nframe_life: 6\n", None),
}


@pytest.mark.parametrize("name", sorted(_CONFIG_FILES))
def test_config_load_reads_and_fails_as_the_jax_package_does(tmp_path, name):
    """A file the JAX package refuses, the port refuses with the same
    exception type; a file it reads (YAML's anchors and aliases), the port
    reads to the same config."""
    text, error = _CONFIG_FILES[name]
    path = tmp_path / "c.yaml"
    path.write_text(text)

    def outcome(cls):
        try:
            return _config_fields(cls.load(str(path)))
        except Exception as e:  # noqa: BLE001 - the exception's type is the outcome compared
            return type(e)

    ours, theirs = outcome(FrontendConfig), outcome(JaxConfig)
    assert ours == theirs
    if error is None:
        assert ours["fast_threshold"] == ours["stereo_threshold_padding"] == 12.5 and ours["frame_life"] == 6
    else:
        assert issubclass(ours, error)


@pytest.mark.parametrize("source", ["write_directory", "mh_01"])
def test_euroc_sensor_files_read_as_the_jax_package_reads_them(tmp_path, source):
    """io/euroc.write_directory's own sensor.yaml, and the published MH_01
    form (a `%YAML:1.0` directive, comments, a flow list over four lines):
    the port's camera parameters equal the JAX package's."""
    if source == "write_directory":
        teuroc.write_directory(str(tmp_path), [], SyntheticRig(**SMALL_RIG))
    else:
        os.makedirs(tmp_path / "mav0" / "cam0")
        (tmp_path / "mav0" / "cam0" / "sensor.yaml").write_text(_SENSOR_YAML)
    cam = str(tmp_path / "mav0" / "cam0")
    (ours, T), (theirs, jT) = teuroc._cam_params(cam), jeuroc._cam_params(cam)
    assert ours == theirs and len(ours) == 9
    assert T.dtype == jT.dtype == np.float64
    np.testing.assert_array_equal(T, jT)


def _kitti_calib_dir(path, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    P0 = np.hstack([np.array([[rng.uniform(400, 700), 0, 320.5], [0, rng.uniform(400, 700), 240.25], [0, 0, 1]]),
                    np.zeros((3, 1))])
    P1 = P0.copy()
    P1[0, 3] = -P0[0, 0] * rng.uniform(0.1, 0.6)
    with open(os.path.join(path, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1), ("P2", P0), ("Tr", P0)):
            f.write(f"{name}: " + " ".join(repr(float(v)) for v in P.ravel()) + "\n")


def _euroc_sensor_dirs(root, seed):
    rng = np.random.default_rng(seed)
    for cam in ("cam0", "cam1"):
        d = os.path.join(root, "mav0", cam)
        os.makedirs(d, exist_ok=True)
        q = rng.normal(size=4)
        T = np.eye(4)
        from vision_slam_frontend_tpu_torch.utils import np_geom

        T[:3, :3] = np_geom.axis_angle_to_matrix(rng.normal(0, 0.1, 3)) if cam == "cam1" else np.eye(3)
        T[:3, 3] = rng.normal(0, 0.1, 3)
        data = ", ".join(repr(float(v)) for v in T.ravel()[:8]) + ",\n         " + ", ".join(repr(float(v)) for v in T.ravel()[8:])
        text = (_SENSOR_YAML.split("T_BS:")[0] + f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{data}]\n"
                + f"intrinsics: [{', '.join(repr(float(v)) for v in rng.uniform(200, 500, 4))}] # fu, fv, cu, cv\n"
                + f"distortion_coefficients: [{', '.join(repr(float(v)) for v in (q * 1e-2)[:4])}]\n")
        with open(os.path.join(d, "sensor.yaml"), "w") as f:
            f.write(text)


@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_calibrations_equal_the_jax_packages(tmp_path, seed):
    seq = str(tmp_path / "sequences" / "03")
    _kitti_calib_dir(seq, seed)
    assert tkitti.kitti_calib(str(tmp_path), "03") == jkitti.kitti_calib(str(tmp_path), "03")
    assert tkitti.kitti_calib(seq) == jkitti.kitti_calib(seq)
    root = str(tmp_path / "euroc")
    _euroc_sensor_dirs(root, seed)
    assert teuroc.euroc_calib(root) == jeuroc.euroc_calib(root)
    FrontendConfig(calib=teuroc.euroc_calib(root)).save(str(tmp_path / "e.yaml"))
    assert FrontendConfig.load(str(tmp_path / "e.yaml")).calib == JaxConfig.load(str(tmp_path / "e.yaml")).calib
