"""General math helpers (port of utils/math.py: the reference's
math_util.h equivalents) on tensors. Python numbers become float32
tensors; every function broadcasts.
"""

from __future__ import annotations

import math as _math

import torch

TWO_PI = 2.0 * _math.pi


def _t(x, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype or torch.float32)


def clamp(x, lo, hi):
    return torch.minimum(torch.maximum(_t(x), _t(lo)), _t(hi))


def deg_to_rad(d):
    return _t(d) * (_math.pi / 180.0)


def rad_to_deg(r):
    return _t(r) * (180.0 / _math.pi)


def angle_mod(a):
    """Normalize an angle to (-pi, pi]."""
    a = _t(a)
    return a - TWO_PI * torch.floor((a + _math.pi) / TWO_PI)


def angle_diff(a, b):
    """Signed difference a - b normalized to (-pi, pi]."""
    return angle_mod(_t(a) - _t(b))


def angle_dist(a, b):
    """Absolute angular distance."""
    return angle_diff(a, b).abs()


def sq(x):
    return _t(x) ** 2


def cube(x):
    return _t(x) ** 3


def ramp(x, x0, x1, y0, y1):
    """Linear interpolation of x from [x0, x1] to [y0, y1], clamped."""
    t = clamp((_t(x) - x0) / (x1 - x0), 0.0, 1.0)
    return y0 + t * (y1 - y0)


def solve_quadratic(a, b, c):
    """Real roots of a x^2 + b x + c = 0: (num_roots, r0, r1), r0 <= r1,
    by NaN-free masking; one root fills both, none gives zeros. Float64
    where `a` is float64, else float32."""
    a = _t(a)
    a = a if a.dtype == torch.float64 else a.to(torch.float32)
    b, c = _t(b, a.dtype), _t(c, a.dtype)
    disc = b * b - 4.0 * a * c
    sq_disc = torch.sqrt(disc.clamp(min=0.0))
    # Stable form: q = -(b + sign(b) sqrt(disc)) / 2.
    q = -0.5 * (b + torch.where(b >= 0, sq_disc, -sq_disc))
    linear = a.abs() < 1e-12
    b_ok = b.abs() > 1e-12
    r_lin = torch.where(b_ok, -c / torch.where(b_ok, b, 1.0), 0.0)
    r0 = torch.where(linear, r_lin, q / torch.where(linear, 1.0, a))
    q_ok = q.abs() > 1e-30
    r1 = torch.where(linear, r_lin, torch.where(q_ok, c / torch.where(q_ok, q, 1.0), r0))
    one, two, zero = (torch.tensor(v, dtype=torch.int32) for v in (1, 2, 0))
    n = torch.where(linear, torch.where(b_ok, one, zero),
                    torch.where(disc > 0, two, torch.where(disc == 0, one, zero)))
    r0, r1 = torch.minimum(r0, r1), torch.maximum(r0, r1)
    valid = n > 0
    return n, torch.where(valid, r0, 0.0), torch.where(valid, r1, 0.0)


def solve_cubic(a, b, c, d, iters: int = 64):
    """One real root of a x^3 + b x^2 + c x + d = 0 (a != 0), by `iters`
    bisection steps on the Cauchy bound's interval."""
    a = _t(a)
    b_, c_, d_ = _t(b) / a, _t(c) / a, _t(d) / a

    def f(x):
        return ((x + b_) * x + c_) * x + d_

    bound = 1.0 + torch.maximum(b_.abs(), torch.maximum(c_.abs(), d_.abs()))
    lo, hi = -bound, bound
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        same = torch.sign(f(mid)) == torch.sign(f(lo))
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    return 0.5 * (lo + hi)
