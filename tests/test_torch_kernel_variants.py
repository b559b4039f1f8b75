"""The window-gather kernel's plain version (ops/cuda_kernels.
patch_windows_plain) against the TPU probe's Pallas kernel
(probe_kernel_variants.run_variant) run in TPU interpret mode on the CPU,
for all five of the probe's bodies and on the edge cases of
torch_edge_cases.window_cases; exact. The bodies below are the probe's own
(probe_kernel_variants.main), which it defines locally.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import probe_kernel_variants as pkv  # noqa: E402
import torch_edge_cases as edge_cases  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv  # noqa: E402

LW = pkv.LW
H, W = 48, 64


def body_e1(img_ref, ky, kx, Wp):
    rows = img_ref[pl.ds(ky, 32), :]
    return rows[:, :LW]


def body_e2(img_ref, ky, kx, Wp):
    rows = img_ref[pl.ds(ky, 31), :]
    return rows[:, :LW]


def body_e3(img_ref, ky, kx, Wp):
    rows = img_ref[pl.ds(ky, 32), :]
    cols = jax.lax.broadcasted_iota(jnp.int32, (Wp, LW), 0)
    sel = jax.lax.broadcasted_iota(jnp.int32, (Wp, LW), 1) + kx
    oh = (cols == sel).astype(jnp.float32)
    return jax.lax.dot(rows, oh, preferred_element_type=jnp.float32)


def body_e4(img_ref, ky, kx, Wp):
    rows = img_ref[pl.ds(ky, 32), :]
    return pltpu.roll(rows, -kx, 1)[:, :LW]


# The probe's cases, as (body, rows, block), beside the port's CASES.
PROBE_CASES = ((body_e1, 32, 64), (body_e2, 31, 64), (body_e3, 32, 64), (body_e4, 32, 64), (body_e1, 32, 8))


@pytest.mark.parametrize("case", range(len(kv.CASES)), ids=[c[0].split()[0] for c in kv.CASES])
def test_patch_windows_plain_matches_probe_kernel(case):
    name, rows, shifted, block = kv.CASES[case]
    body, probe_rows, probe_block = PROBE_CASES[case]
    assert (rows, block) == (probe_rows, probe_block)
    K = 2 * block
    img, ys, xs = kv.probe_inputs(H, W, K, torch.device("cpu"), seed=case)
    with pltpu.force_tpu_interpret_mode():
        ref = pkv.run_variant(name, body, rows, K, H, W, block)(
            jnp.asarray(img.numpy()), jnp.asarray(ys.numpy()), jnp.asarray(xs.numpy()))
    out = ck.patch_windows(img, ys, xs, rows, shifted, block)
    assert out.shape == (K, rows, LW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _shifted_body(rows):
    """The probe's roll body (E4) at `rows` rows: the shifted read at 31 rows,
    which the probe itself runs only at 32."""
    def body(img_ref, ky, kx, Wp):
        return pltpu.roll(img_ref[pl.ds(ky, rows), :], -kx, 1)[:, :LW]
    return body


def _numpy_windows(img, ys, xs, rows, shifted):
    """Windows cut out of the image zero-padded by more than any window reaches."""
    H, W = img.shape
    pad = int(np.abs(np.concatenate([ys, xs])).max()) + rows + LW
    padded = np.pad(img, pad)
    c0 = xs if shifted else np.zeros_like(xs)
    return np.stack([padded[pad + y : pad + y + rows, pad + c : pad + c + LW] for y, c in zip(ys, c0)])


WINDOW_CASES = edge_cases.window_cases()


@pytest.mark.parametrize("case", range(len(WINDOW_CASES)), ids=[c[0] for c in WINDOW_CASES])
def test_patch_windows_plain_matches_references_on_edge_cases(case):
    """Windows leaving the image on every side and past the probe's padding,
    xs at every residue mod 4, widths not a multiple of 4, K not a multiple of
    `block`, an image view at an element offset: against numpy, and against
    the probe's kernel in interpret mode on the windows its padded image holds
    (0 <= ys <= H + 8 - rows and, shifted, 0 <= xs <= W; the TPU reads past it
    are undefined), repeated to a multiple of `block`.
    Exact."""
    _, img, ys, xs, rows, shifted, block, offset = WINDOW_CASES[case]
    H, W = img.shape
    out = ck.patch_windows(edge_cases.at_offset(img, offset), torch.from_numpy(ys), torch.from_numpy(xs), rows,
                           shifted, block).numpy()
    np.testing.assert_array_equal(out, _numpy_windows(img, ys, xs, rows, shifted))
    held = (ys >= 0) & (ys <= H + 8 - rows) & (((xs >= 0) & (xs <= W)) if shifted else True)
    assert held.any()
    n = int(held.sum())
    k = -(-n // block) * block
    pys, pxs = (np.resize(a[held], k) for a in (ys, xs))
    if not shifted:
        bodies = (body_e1 if rows == 32 else body_e2,)
    else:
        bodies = (body_e3, body_e4) if rows == 32 else (_shifted_body(rows),)
    for body in bodies:
        with pltpu.force_tpu_interpret_mode():
            ref = pkv.run_variant(body.__name__, body, rows, k, H, W, block)(jnp.asarray(img), jnp.asarray(pys),
                                                                             jnp.asarray(pxs))
        np.testing.assert_array_equal(out[held], np.asarray(ref)[:n])


def test_patch_windows_zero_outside_the_image():
    img = torch.arange(1.0, 1.0 + 6 * 5).reshape(6, 5)
    ys = torch.tensor([-2, 4, 0], dtype=torch.int32)
    xs = torch.tensor([3, 0, 4], dtype=torch.int32)
    out = ck.patch_windows(img, ys, xs, rows=31, shifted=True, block=8)
    assert out.shape == (3, 31, 32)
    assert torch.equal(out[0, 2, :2], img[0, 3:5]) and out[0, :2].abs().sum() == 0
    assert torch.equal(out[1, :2, :5], img[4:6]) and out[1, 2:].abs().sum() == 0
    assert torch.equal(out[2, :6, 0], img[:, 4]) and out[2, :, 1:].abs().sum() == 0
    unshifted = ck.patch_windows(img, ys, xs, rows=32, shifted=False, block=64)
    assert torch.equal(unshifted[2, :6, :5], img)


def test_patch_windows_wrapper_checks_input():
    img = torch.zeros((40, 40))
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 image"):
        ck.patch_windows(img.double(), i, i)
    with pytest.raises(ValueError, match="int32 ys and xs"):
        ck.patch_windows(img, i.long(), i)
    with pytest.raises(ValueError, match="rows"):
        ck.patch_windows(img, i, i, rows=30)
    with pytest.raises(ValueError, match="block"):
        ck.patch_windows(img, i, i, block=16)


def test_kernel_variants_entry_point_on_the_cpu(capsys, monkeypatch):
    assert kv.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + len(kv.CASES) and all("parity=OK" in line for line in out[1:])
    img, ys, xs = kv.probe_inputs(48, 64, 16, torch.device("cpu"))
    padded = torch.nn.functional.pad(img, (0, 32, 0, 8))
    for rows, shifted in ((32, True), (31, False)):
        r_idx, c_idx = kv.gather_indices(ys, xs, rows, shifted)
        assert torch.equal(kv.index_gather(padded, r_idx, c_idx), ck.patch_windows_plain(img, ys, xs, rows, shifted))
    # The default device is the card; without one the entry point raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.main([])
