"""Runtime invariant checks of the BA solver (port of utils/checks.py's
check_ba_step; numpy on the host)."""

from __future__ import annotations

import numpy as np


class InvariantViolation(RuntimeError):
    """A solver output violated a framework invariant."""


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu()) if hasattr(x, "detach") else np.asarray(x)


def check_ba_step(it: int, d_pose, d_lm) -> None:
    """Validate one BA solver step (tensors or arrays) before it is applied."""
    if not np.isfinite(_host(d_pose)).all():
        raise InvariantViolation(f"BA iter {it}: non-finite pose update")
    if not np.isfinite(_host(d_lm)).all():
        raise InvariantViolation(f"BA iter {it}: non-finite landmark update")
