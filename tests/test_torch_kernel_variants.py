"""The window-gather kernel's plain version (ops/cuda_kernels.
patch_windows_plain) against the TPU probe's Pallas kernel
(probe_kernel_variants.run_variant) run in TPU interpret mode on the CPU,
for all five of the probe's bodies; exact. The bodies below are the probe's
own (probe_kernel_variants.main), which it defines locally.
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
