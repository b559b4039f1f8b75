"""The port's PLY and HTML exports against the JAX package's on the same
problems (equal bytes, equal text), and the `--ply` flags of the port's
slam_backend and slam_merge CLIs, whose files equal the JAX package's export
of the problems those CLIs wrote.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_torch_io import _problem  # noqa: E402
from vision_slam_frontend_tpu.io.serialize import load_problem as jax_load_problem  # noqa: E402
from vision_slam_frontend_tpu.types import slam_types as jtypes  # noqa: E402
from vision_slam_frontend_tpu.viz import html as jhtml  # noqa: E402
from vision_slam_frontend_tpu.viz import ply as jply  # noqa: E402
from vision_slam_frontend_tpu_torch.types import slam_types as ttypes  # noqa: E402
from vision_slam_frontend_tpu_torch.viz import html as thtml  # noqa: E402
from vision_slam_frontend_tpu_torch.viz import ply as tply  # noqa: E402

EXT = np.array([[0.0, 0.0, 1.0, 0.1], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.5], [0, 0, 0, 1]])


@pytest.mark.parametrize("seed,ext", [(0, None), (1, EXT), (2, EXT)])
def test_ply_and_html_equal_the_jax_packages(tmp_path, seed, ext):
    ours, theirs = _problem(ttypes, seed), _problem(jtypes, seed)
    s_ours = tply.export_ply(str(tmp_path / "p.ply"), ours, ext)
    s_theirs = jply.export_ply(str(tmp_path / "j.ply"), theirs, ext)
    assert s_ours == s_theirs and s_ours["landmarks"] > 0
    assert open(tmp_path / "p.ply", "rb").read() == open(tmp_path / "j.ply", "rb").read()
    kw = dict(max_landmarks=4, refresh_seconds=2.0) if seed == 2 else {}
    h_ours = thtml.export_html(str(tmp_path / "p.html"), ours, ext, **kw)
    h_theirs = jhtml.export_html(str(tmp_path / "j.html"), theirs, ext, **kw)
    assert h_ours == h_theirs
    assert open(tmp_path / "p.html").read() == open(tmp_path / "j.html").read()
    assert not os.path.exists(tmp_path / "p.html.tmp")


def test_empty_problem_exports_equal_the_jax_packages(tmp_path):
    assert tply.export_ply(str(tmp_path / "p.ply"), ttypes.SLAMProblem()) == \
        jply.export_ply(str(tmp_path / "j.ply"), jtypes.SLAMProblem()) == {"nodes": 0, "landmarks": 0, "edges": 0}
    assert open(tmp_path / "p.ply", "rb").read() == open(tmp_path / "j.ply", "rb").read()
    thtml.export_html(str(tmp_path / "p.html"), ttypes.SLAMProblem())
    jhtml.export_html(str(tmp_path / "j.html"), jtypes.SLAMProblem())
    assert open(tmp_path / "p.html").read() == open(tmp_path / "j.html").read()


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    from vision_slam_frontend_tpu_torch.cli import slam_frontend

    tmp = tmp_path_factory.mktemp("viz")
    out = str(tmp / "s.npz")
    assert slam_frontend.main(["--input", "synthetic:6", "--output", out, "--device", "cpu",
                               "--max_features", "192", "--frame_life", "4"]) == 0
    return tmp, out


def _jax_ply_of(npz: str, path: str) -> bytes:
    with np.load(npz) as data:
        ext = data["calib_left_cam_to_robot"]
    jply.export_ply(path, jax_load_problem(npz), ext)
    return open(path, "rb").read()


def test_slam_backend_ply(session, capsys):
    from vision_slam_frontend_tpu_torch.cli import slam_backend

    tmp, npz = session
    out, ply = str(tmp / "ba.npz"), str(tmp / "ba.ply")
    assert slam_backend.main(["--input", npz, "--output", out, "--ply", ply, "--device", "cpu"]) == 0
    assert f"Wrote {ply}: {{'nodes': 5" in capsys.readouterr().out
    data = open(ply, "rb").read()
    assert data.startswith(b"ply\nformat binary_little_endian")
    assert data == _jax_ply_of(out, str(tmp / "ba_jax.ply"))


def test_slam_merge_ply(session, capsys):
    from vision_slam_frontend_tpu_torch.cli import slam_merge

    tmp, npz = session
    out, ply = str(tmp / "m.npz"), str(tmp / "m.ply")
    assert slam_merge.main(["--inputs", npz, npz, "--output", out, "--ply", ply, "--device", "cpu",
                            "--transforms", "0,0,0,1,0,0,0;0.3,0,0.2,1,0,0,0", "--max_iterations", "3"]) == 0
    assert f"Wrote {ply}: {{'nodes': 10" in capsys.readouterr().out
    assert open(ply, "rb").read() == _jax_ply_of(out, str(tmp / "m_jax.ply"))
