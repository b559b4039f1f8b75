"""Runtime invariant checks (port of utils/checks.py; numpy on the host).

`check_keyframe_result` validates each keyframe's fetched outputs (NaN/Inf,
pixel bounds, index ranges, capacity), enabled by
`FrontendConfig(validate=True)` or the CLI's `--validate`; `check_ba_step`
validates each BA solver step. `checkified` runs a function with every aten
op checked as it runs (NaN, division by zero, out-of-range
indices): the counterpart of the JAX package's jax.experimental.checkify
sanitizer, a debug tool that is never on by default.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class InvariantViolation(RuntimeError):
    """A keyframe or solver output violated a framework invariant."""


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu()) if hasattr(x, "detach") else np.asarray(x)


def _fail(frame_id: int, msg: str):
    raise InvariantViolation(f"keyframe {frame_id}: {msg}")


def check_keyframe_result(frame_id: int, r, image_shape, capacity: int) -> None:
    """Validate one fetched KeyframeResult (numpy arrays or tensors); raises
    InvariantViolation naming the keyframe and the invariant."""
    h, w = int(image_shape[0]), int(image_shape[1])
    n = int(_host(r.num_features))
    if not (0 <= n <= capacity):
        _fail(frame_id, f"num_features {n} outside [0, {capacity}]")
    valid = _host(r.feat_valid)
    if int(valid.sum()) != n:
        _fail(frame_id, f"feat_valid popcount {int(valid.sum())} != num_features {n}")
    if n == 0:
        return

    for name in ("pixels_undist", "pixels_raw", "right_pixels_raw", "right_pixels_undist", "points3d"):
        a = _host(getattr(r, name))[:n]
        if not np.isfinite(a).all():
            bad = int(np.sum(~np.isfinite(a).all(axis=-1)))
            _fail(frame_id, f"{name}: {bad}/{n} rows non-finite")

    # Raw detections lie inside the image (undistorted pixels may leave it).
    raw = _host(r.pixels_raw)[:n]
    if (raw[:, 0] < 0).any() or (raw[:, 0] >= w).any() or (raw[:, 1] < 0).any() or (raw[:, 1] >= h).any():
        _fail(frame_id, f"pixels_raw outside {w}x{h} image bounds")

    tid = _host(r.track_id)[:n]
    if (tid < 0).any():
        _fail(frame_id, "negative track id")
    if (tid > frame_id * capacity + capacity).any():
        _fail(frame_id, f"track id exceeds newest possible id for frame {frame_id}")

    widx = _host(r.window_curr_idx)
    wmatched = _host(r.window_matched)
    if wmatched.any():
        sel = widx[wmatched]
        if (sel < 0).any() or (sel >= capacity).any():
            _fail(frame_id, "window match index outside [0, capacity)")
        # Matches point at valid (compacted) current features.
        if (sel >= n).any():
            _fail(frame_id, f"window match points at invalid feature (>= {n})")


def check_ba_step(it: int, d_pose, d_lm) -> None:
    """Validate one BA solver step (tensors or arrays) before it is applied."""
    if not np.isfinite(_host(d_pose)).all():
        raise InvariantViolation(f"BA iter {it}: non-finite pose update")
    if not np.isfinite(_host(d_lm)).all():
        raise InvariantViolation(f"BA iter {it}: non-finite landmark update")


class CheckError:
    """The outcome of `checkified`: `get()` is the first failed check's
    message or None; `throw()` raises it as InvariantViolation."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise InvariantViolation(self._message)


class _Stop(Exception):
    """Ends the checked function at an op that must not run."""


_aten = torch.ops.aten
# Ops that only move, select or allocate data: a NaN in their output is a
# NaN they were given (or uninitialized memory), as jax.experimental.checkify
# leaves its data-movement primitives unchecked.
_MOVES = {
    "_to_copy", "alias", "cat", "clone", "constant_pad_nd", "copy", "copy_", "detach", "empty", "empty_like",
    "empty_permuted", "empty_strided", "expand", "fill", "fill_", "flip", "full", "full_like", "gather",
    "index", "index_put", "index_put_", "_index_put_impl_", "index_select", "lift_fresh", "lift_fresh_copy",
    "masked_fill", "masked_fill_", "new_empty", "new_empty_strided", "new_full", "new_zeros", "new_ones",
    "repeat", "resize_", "roll", "scalar_tensor", "scatter", "scatter_", "select_scatter", "set_",
    "slice_scatter", "sort", "stack", "take", "topk", "where", "zeros", "zeros_like", "ones", "ones_like",
    "maximum", "minimum", "max", "min", "amax", "amin", "clamp", "clamp_", "clamp_min", "clamp_max", "neg",
    "abs", "sign", "masked_select", "_unsafe_view",
}
# Division ops, of any dtype, as jax.experimental.checkify's division check.
_DIVISIONS = {"div", "div_", "floor_divide", "floor_divide_", "remainder", "remainder_", "fmod", "fmod_",
              "reciprocal", "reciprocal_"}
# Index ops: (position of the indexed tensor's dim argument or None, position
# of the index tensor, whether negative indices count from the end).
_INDEXERS = {
    "index_select": (1, 2, False), "gather": (1, 2, False), "scatter": (1, 2, False), "scatter_": (1, 2, False),
    "scatter_add": (1, 2, False), "scatter_add_": (1, 2, False), "scatter_reduce": (1, 2, False),
    "scatter_reduce_": (1, 2, False), "index_add": (1, 2, False), "index_add_": (1, 2, False),
    "index_copy": (1, 2, False), "index_copy_": (1, 2, False), "index_fill": (1, 2, False),
    "index_fill_": (1, 2, False), "take": (None, 1, True),
}


def _op_name(func) -> str:
    return f"{func.namespace}.{func.overloadpacket.__name__}"


class _Checks(TorchDispatchMode):
    """Checks each aten op as it is dispatched; records the first failure.
    Index and division checks run before the op (on CUDA an out-of-range
    index is a device-side assert, which poisons the context), the NaN
    check after it. Each op costs one host sync."""

    def __init__(self):
        super().__init__()
        self.message = None

    def _index_ranges(self, func, name, args):
        """[(index tensor, size it indexes, negatives allowed)] of an index op."""
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            out, dim = [], 0
            for idx in args[1]:
                if idx is None:
                    dim += 1
                elif idx.dtype in (torch.bool, torch.uint8):
                    dim += idx.dim()  # a mask selects; it cannot leave the tensor
                else:
                    out.append((idx, args[0].shape[dim], True))
                    dim += 1
            return out
        if name in _INDEXERS:
            dim_pos, idx_pos, negative = _INDEXERS[name]
            if len(args) <= idx_pos or not isinstance(args[idx_pos], torch.Tensor):
                return []
            src = args[0]
            if dim_pos is None:
                size = src.numel()
            else:
                size = src.shape[args[dim_pos]] if src.dim() else 1
            return [(args[idx_pos], size, negative)]
        return []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.message is not None:
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        before = []  # (flag tensor, message)
        for idx, size, negative in self._index_ranges(func, name, args):
            if idx.numel():
                low = -size if negative else 0
                bad = (idx < low) | (idx >= size)
                before.append((bad.any(), f"out-of-bounds index for a dimension of size {size} in {_op_name(func)}"))
        if name in _DIVISIONS:
            den = args[0] if name.startswith("reciprocal") else args[1] if len(args) > 1 else None
            if isinstance(den, torch.Tensor) and den.numel():
                before.append(((den == 0).any(), f"division by zero in {_op_name(func)}"))
            elif isinstance(den, (int, float)) and not isinstance(den, bool) and den == 0:
                before.append((torch.tensor(True), f"division by zero in {_op_name(func)}"))
        if before:
            flags = torch.stack([f.cpu() for f, _ in before]).tolist()  # the op's one sync
            for bad, (_, msg) in zip(flags, before):
                if bad:
                    self.message = msg
                    raise _Stop
        out = func(*args, **kwargs)
        if name not in _MOVES and not func.is_view:
            floats = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if floats and torch.stack([torch.isnan(t).any().cpu() for t in floats]).any().item():
                self.message = f"nan generated by {_op_name(func)}"
        return out


def checkified(fn, *args, **static):
    """Run `fn(*args, **static)` with every aten op checked as it runs.
    Returns (CheckError, result): `error.get()` is the first failure's
    message or None, `error.throw()` raises it.

    Checked: a floating output holding NaN, named by the op that produced it
    ("nan generated by aten.sqrt"; ops that only move or select data pass a
    NaN on unchecked, as in jax.experimental.checkify), division by zero
    (integer or floating, as checkify's division check), and out-of-range
    indices of index, index_select, gather,
    take_along_dim, take, scatter* and index_put. Index and division checks
    run before the op is dispatched: such an op is not run, the function
    stops there, and the result is None (on CUDA the op would be a
    device-side assert that poisons the context). A debug tool, never on by
    default: it syncs with the device once per op, so a checked GPU step is
    far slower than the plain one."""
    mode = _Checks()
    result = None
    try:
        with mode:
            result = fn(*args, **static)
    except _Stop:
        result = None
    return CheckError(mode.message), result
