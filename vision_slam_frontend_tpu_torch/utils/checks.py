"""Runtime invariant checks (port of utils/checks.py; numpy on the host).

`check_keyframe_result` validates each keyframe's fetched outputs (NaN/Inf,
pixel bounds, index ranges, capacity), enabled by
`FrontendConfig(validate=True)` or the CLI's `--validate`; `check_ba_step`
validates each BA solver step. The JAX package's device-side
`checkified` (jax.experimental.checkify) has no counterpart here.
"""

from __future__ import annotations

import numpy as np


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
