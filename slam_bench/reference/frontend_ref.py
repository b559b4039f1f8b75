"""Plain reference of the stereo ORB frontend: from the same images and
odometry, every keyframe's nodes, matches, track ids and 3-D points.

Plain PyTorch and NumPy; it imports nothing of the program. Its arithmetic
is a frozen copy of the program's plain (CPU) paths: FAST-9 with strict 3x3
NMS, exact top-K with the sub-pixel fit, the linear pyramid, the separable
blur as shifted adds, the f16 patch, centroid angle and steered BRIEF,
Hamming kNN(2) over unpacked bits, the ratio, best-percent and one-to-one
cuts, the adaptive epipolar gate, the odometry-guided gate, the track
scatter-min, undistortion and the float64 DLT. It is organised
differently: detection and description run over many keyframes at once
(every op there is elementwise, a sort per row or an exact integer sum, so
batching changes no bit), then the window runs keyframe by keyframe.

`lowp=True` is the control: the image arithmetic (blur, resize) rounded to
bfloat16, undistortion in bfloat16 and the triangulation in float32, one
step below what the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9
PATCH_RADIUS = 15
PATCH = 31
NUM_BITS = 256
NUM_BINS = 32
LARGE = 1e9


# --------------------------------------------------------------------------
# Host geometry: quaternions, calibration matrices (float64 / float32 numpy)
# --------------------------------------------------------------------------


def q_normalize(q):
    return q / max(float(np.linalg.norm(q)), 1e-12)


def q_multiply(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], np.float64)


def q_inverse(q):
    return q_normalize(np.array([q[0], -q[1], -q[2], -q[3]], np.float64))


def q_rotate(q, v):
    w, u = q[0], np.asarray(q[1:], np.float64)
    v = np.asarray(v, np.float64)
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def q_angle(a, b):
    d = abs(float(np.dot(q_normalize(a), q_normalize(b))))
    return 2.0 * float(np.arccos(min(1.0, d)))


def _f32(v) -> float:
    return float(np.float32(v))


def _intrinsics(d: dict) -> dict:
    return {k: _f32(d.get(k, 0.0)) for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")}


def _kmat(i):
    return np.array([[i["fx"], 0.0, i["cx"]], [0.0, i["fy"], i["cy"]], [0.0, 0.0, 1.0]], np.float32)


def _kinv(K):
    one = np.ones((), K.dtype)
    ifx, ify = one / K[0, 0], one / K[1, 1]
    return np.array([[ifx, 0.0, -(K[0, 2] * ifx)], [0.0, ify, -(K[1, 2] * ify)], [0.0, 0.0, 1.0]], K.dtype)


def _skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]], dtype=np.asarray(v).dtype)


class Rig:
    """Calibration as the frontend states it: a calib dict (intrinsics_left,
    intrinsics_right, right_extrinsic [R | t] with x_right = R x_left + t,
    left_cam_to_robot_rotation and _translation)."""

    def __init__(self, calib: dict):
        self.il = _intrinsics(calib["intrinsics_left"])
        self.ir = _intrinsics(calib["intrinsics_right"])
        K_l, K_r = _kmat(self.il), _kmat(self.ir)
        A = np.asarray(calib["right_extrinsic"], np.float32)
        R, t = A[:, :3], A[:, 3]
        self.P_left = (K_l @ np.hstack([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)])).astype(np.float32)
        self.P_right = (K_r @ A).astype(np.float32)
        self.F = (_kinv(K_r).T @ (_skew(t) @ R) @ _kinv(K_l)).T.astype(np.float32)
        self.cam_R = np.asarray(calib["left_cam_to_robot_rotation"], np.float32)
        self.cam_t = np.asarray(calib["left_cam_to_robot_translation"], np.float32)


# --------------------------------------------------------------------------
# Batched detection and description: images (B, H, W)
# --------------------------------------------------------------------------


def _fast(img):
    """(B, H, W) -> (raw, suppressed) FAST-9 scores, zero padding outside."""
    B, H, W = img.shape
    x = F.pad(img.to(torch.float32), (4, 4, 4, 4))
    rows, cols = H + 2, W + 2
    c = x[:, 3:3 + rows, 3:3 + cols]
    diff = torch.stack([x[:, 3 + dy:3 + dy + rows, 3 + dx:3 + dx + cols] for dy, dx in RING]) - c

    def polarity(d):
        ext = torch.cat([d, d[:ARC - 1]])
        m = ext[0:16]
        for i in range(1, ARC):
            m = torch.minimum(m, ext[i:i + 16])
        return m.amax(0)

    score = torch.maximum(polarity(diff), polarity(-diff))
    raw = score[:, 1:1 + H, 1:1 + W]
    neigh = torch.stack([score[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]).amax(0)
    return raw.contiguous(), torch.where(raw > neigh, raw, float("-inf"))


def _interior(H, W, margin, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)


def _top_k_subpixel(score, raw, k):
    B, H, W = score.shape
    top_s, top_i = torch.sort(score.reshape(B, -1), dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    valid = torch.isfinite(top_s)
    kx, ky = top_i % W, top_i // W
    rflat = raw.reshape(B, -1)
    last = H * W - 1

    def offset(im, ip, ic):
        s_m = rflat.gather(1, im.clamp(0, last))
        s_p = rflat.gather(1, ip.clamp(0, last))
        s_c = rflat.gather(1, ic)
        den = s_m - 2.0 * s_c + s_p
        flat = den.abs() < 1e-6
        off = 0.5 * (s_m - s_p) / torch.where(flat, 1e-6, den)
        return torch.where(flat, 0.0, off).clamp(-0.5, 0.5)

    ic = ky * W + kx
    dx = offset(ic - 1, ic + 1, ic)
    dy = offset(ic - W, ic + W, ic)
    kps = torch.stack([kx.to(torch.float32) + dx, ky.to(torch.float32) + dy], -1)
    return torch.where(valid[..., None], kps, 0.0), valid


def _lowp(x, lowp):
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def _blur(img, sigma, lowp=False):
    r = int(math.ceil(3.0 * sigma))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    kk = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    taps = [float(w) for w in kk / kk.sum()]

    def filt(x, dim):
        pad = (0, 0, r, r) if dim == -2 else (r, r, 0, 0)
        p = F.pad(x, pad)
        n = x.shape[dim]
        acc = None
        for i, w in enumerate(taps):
            term = p.narrow(dim, i, n) * w
            acc = term if acc is None else acc + term
        return _lowp(acc, lowp)

    return filt(filt(img, -2), -1)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kscale = f32(max(float(inv_scale), 1.0))
    centres = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centres * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kscale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(img, shape, lowp=False):
    """(B, H, W) float32 -> (B, h, w): the antialiased linear resize, taps
    summed rows first, then columns, in increasing input order."""
    out = img
    for axis, size in ((1, shape[0]), (2, shape[1])):
        n_in = out.shape[axis]
        if size == n_in:
            continue
        w = _resize_weights(n_in, size)
        nz = w != 0
        first = np.where(nz.any(0), nz.argmax(0), 0)
        T = max(int(nz.sum(0).max()), 1)
        idx = np.minimum(first[None, :] + np.arange(T)[:, None], n_in - 1)
        wts = np.take_along_axis(w, idx, axis=0)
        wts = np.where(first[None, :] + np.arange(T)[:, None] < n_in, wts, 0.0).astype(np.float32)
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(img.device)
        wts_t = torch.from_numpy(wts).to(img.device)
        acc = None
        for t in range(T):
            wt = wts_t[t][:, None] if axis == 1 else wts_t[t][None, :]
            term = out.index_select(axis, idx_t[t]) * wt
            acc = term if acc is None else acc + term
        out = _lowp(acc, lowp)
    return out


def _brief_tables(device):
    rng = np.random.RandomState(7)
    sigma = PATCH_RADIUS / 2.5
    pts = rng.normal(0.0, sigma, size=(NUM_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    lim = PATCH_RADIUS - 2
    pattern = np.where(norm > lim, pts * (lim / np.maximum(norm, 1e-9)), pts).astype(np.float32)
    rot = np.zeros((NUM_BINS, NUM_BITS, 2, 2), np.int32)
    px, py = pattern[..., 0], pattern[..., 1]
    for b in range(NUM_BINS):
        th = 2.0 * np.pi * b / NUM_BINS
        c, s = np.cos(th), np.sin(th)
        rot[b, ..., 0] = np.rint(c * px - s * py)
        rot[b, ..., 1] = np.rint(s * px + c * py)
    rot_a = (rot[:, :, 0, 1] + PATCH_RADIUS) * PATCH + (rot[:, :, 0, 0] + PATCH_RADIUS)
    rot_b = (rot[:, :, 1, 1] + PATCH_RADIUS) * PATCH + (rot[:, :, 1, 0] + PATCH_RADIUS)
    dy, dx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    disk = (dx * dx + dy * dy) <= PATCH_RADIUS * PATCH_RADIUS
    moments = np.stack([(dx * disk).ravel(), (dy * disk).ravel()], 1).astype(np.float64)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_t(moments), as_t(rot_a.astype(np.int64)), as_t(rot_b.astype(np.int64))


def pack_bits(bits):
    lead = bits.shape[:-1]
    b = bits.to(torch.int64).reshape(*lead, bits.shape[-1] // 32, 32)
    v = (b << torch.arange(32, dtype=torch.int64, device=bits.device)).sum(-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits(packed):
    bits = (packed[..., None] >> torch.arange(32, dtype=torch.int32, device=packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).to(torch.float32)


def level_shapes(H: int, W: int, levels: int, scale_factor: float, border: int):
    """[(h, w, budget share index, scale)] of the pyramid; level 0 is the image."""
    out = [(H, W, 1.0)]
    scale = 1.0
    for _ in range(1, levels):
        scale *= scale_factor
        out.append((max(int(round(H / scale)), 2 * border + 8), max(int(round(W / scale)), 2 * border + 8), scale))
    return out


def level_budgets(k: int, levels: int) -> list[int]:
    b = k // levels
    return [b] * (levels - 1) + [k - b * (levels - 1)]


def extract(images_u8, cfg: dict, tables, lowp=False, keep_levels=False):
    """Detect + describe (B, H, W) uint8 images. Returns keypoints (B, K, 2)
    at level-0 scale, descriptors (B, K, 8) int32, valid (B, K) and, with
    `keep_levels`, each level's (level-scale keypoints, valid)."""
    moments, rot_a, rot_b = tables
    B, H, W = images_u8.shape
    border, K = cfg["detect_border"], cfg["max_features"]
    thr = torch.tensor(cfg["fast_threshold"], dtype=torch.float32, device=images_u8.device)
    image_f = images_u8.to(torch.float32)
    shapes = level_shapes(H, W, cfg["num_levels"], cfg["pyramid_scale"], border)
    budgets = level_budgets(K, cfg["num_levels"])
    parts, per_level = [], []
    for (h, w, scale), budget in zip(shapes, budgets):
        lvl = images_u8 if scale == 1.0 else _resize(image_f, (h, w), lowp)
        raw, sup = _fast(lvl)
        inside = _interior(h, w, max(border, 3), lvl.device)
        score = torch.where(inside & (sup > thr), sup, float("-inf"))
        kps, valid = _top_k_subpixel(score, raw, budget)
        blurred = _blur(lvl.to(torch.float32), cfg["blur_sigma"], lowp)
        planes = blurred.to(torch.float32).to(torch.float16).reshape(B, h * w)
        r = PATCH // 2
        xs = (torch.round(kps[..., 0]).long() - r).clamp(0, w - PATCH)
        ys = (torch.round(kps[..., 1]).long() - r).clamp(0, h - PATCH)
        off = torch.arange(PATCH, device=lvl.device)
        flat = (ys[..., None, None] + off[:, None]) * w + (xs[..., None, None] + off[None, :])
        p = planes.gather(1, flat.reshape(B, -1)).reshape(B, budget, PATCH * PATCH).to(torch.float32)
        m = (p.to(torch.float64) @ moments).to(torch.float32)
        theta = torch.where(valid, torch.atan2(m[..., 1], m[..., 0]), 0.0)
        step = torch.full_like(theta, 2.0 * np.pi / NUM_BINS)
        bins = torch.remainder(torch.round(theta / step).to(torch.int64), NUM_BINS)
        bits = p.gather(2, rot_a[bins]) < p.gather(2, rot_b[bins])
        desc = torch.where(valid[..., None], pack_bits(bits), 0)
        if keep_levels:
            per_level.append((kps, valid))
        parts.append((kps * scale if scale != 1.0 else kps, desc, valid))
    kps, desc, valid = (torch.cat(x, dim=1) for x in zip(*parts))
    return kps, desc, valid, per_level


# --------------------------------------------------------------------------
# Matching and geometry, one keyframe at a time
# --------------------------------------------------------------------------


def knn2(dist, valid_t):
    masked = torch.where(valid_t[None, :], dist, LARGE)
    best = masked.argmin(1)
    d1 = masked.gather(1, best[:, None])[:, 0]
    d2 = masked.scatter(1, best[:, None], LARGE).amin(1)
    return best.to(torch.int32), d1, d2


def hamming_top2(desc_q, desc_t, valid_t):
    bq, bt = unpack_bits(desc_q), unpack_bits(desc_t)
    return knn2(bq.sum(1)[:, None] + bt.sum(1)[None, :] - 2.0 * (bq @ bt.T), valid_t)


def best_percent(dist, matched, fraction):
    masked = torch.where(matched, dist, LARGE)
    K = masked.shape[-1]
    n_good = (matched.sum(-1, dtype=torch.int32).to(torch.float32) * fraction).to(torch.int32)[..., None]
    if K <= 1024:
        less = masked[..., None, :] < masked[..., :, None]
        idx = torch.arange(K, device=dist.device)
        ties = (masked[..., None, :] == masked[..., :, None]) & (idx[None, :] < idx[:, None])
        return matched & ((less | ties).sum(-1) < n_good)
    v = torch.sort(masked, dim=-1).values.gather(-1, (n_good - 1).clamp(min=0).to(torch.int64))
    n_less = ((masked < v) & matched).sum(-1, keepdim=True)
    tie = matched & (masked == v)
    tie_i = tie.to(torch.int32)
    keep = (masked < v) | (tie & (torch.cumsum(tie_i, dim=-1) - tie_i < n_good - n_less))
    return matched & keep & (n_good > 0)


def undistort(intr: dict, px, lowp=False):
    dt = torch.bfloat16 if lowp else torch.float32
    px = px.to(dt)
    xd = px[..., 0] - intr["cx"]
    xd = xd / torch.full_like(xd, intr["fx"])
    yd = px[..., 1] - intr["cy"]
    yd = yd / torch.full_like(yd, intr["fy"])
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (intr["k1"] + r2 * (intr["k2"] + r2 * intr["k3"]))
        xy2 = 2.0 * x * y
        dx = intr["p1"] * xy2 + intr["p2"] * (r2 + 2.0 * x * x)
        dy = intr["p1"] * (r2 + 2.0 * y * y) + intr["p2"] * xy2
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x * intr["fx"] + intr["cx"], y * intr["fy"] + intr["cy"]], -1).to(torch.float32)


def triangulate(P_l, P_r, pl, pr, lowp=False):
    dt = torch.float32 if lowp else torch.float64
    P_l, P_r, pl, pr = (t.to(dt) for t in (P_l, P_r, pl, pr))

    def unit(r):
        sq = r * r
        n = (sq[..., 0] + sq[..., 1] + sq[..., 2] + sq[..., 3]).sqrt()
        return r / n.clamp(min=1e-12)[..., None]

    def rows(P, px):
        u, v = px[..., 0:1], px[..., 1:2]
        return unit(u * P[2][None, :] - P[0][None, :]), unit(v * P[2][None, :] - P[1][None, :])

    l1, l2 = rows(P_l, pl)
    r1, r2 = rows(P_r, pr)
    A = torch.stack([l1, l2, r1, r2], dim=-2)
    Bm, b = A[..., :3], -A[..., 3]
    pM = Bm[..., :, :, None] * Bm[..., :, None, :]
    pv = Bm * b[..., None]
    M = pM[..., 0, :, :] + pM[..., 1, :, :] + pM[..., 2, :, :] + pM[..., 3, :, :]
    v = pv[..., 0, :] + pv[..., 1, :] + pv[..., 2, :] + pv[..., 3, :]
    m00, m01, m02, m11, m12, m22 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2], M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00, c01, c02 = m11 * m22 - m12 * m12, m02 * m12 - m01 * m22, m01 * m12 - m02 * m11
    c11, c12, c22 = m00 * m22 - m02 * m02, m01 * m02 - m00 * m12, m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    x = (c00 * v[..., 0] + c01 * v[..., 1] + c02 * v[..., 2]) / det
    y = (c01 * v[..., 0] + c11 * v[..., 1] + c12 * v[..., 2]) / det
    z = (c02 * v[..., 0] + c12 * v[..., 1] + c22 * v[..., 2]) / det
    return torch.stack([x, y, z], -1).to(torch.float32)


def quat_matrix(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz, xy, xz, yz, wx, wy, wz = x * x, y * y, z * z, x * y, x * z, y * z, w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), 2 * (xy + wz), 1 - 2 * (xx + zz),
                     2 * (yz - wx), 2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


class Window:
    """The last W keyframes' compacted features, slot 0 the oldest."""

    def __init__(self, W, K, threshold, device):
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
        self.kps, self.desc, self.valid = z(W, K, 2), z(W, K, 8, dt=torch.int32), z(W, K, dt=torch.bool)
        self.track_id, self.points3d = z(W, K, dt=torch.int32), z(W, K, 3)
        self.frame_id = torch.full((W,), -1, dtype=torch.int32, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.threshold = torch.tensor(threshold, dtype=torch.float32, device=device)
        self.pose_t = z(W, 3)
        self.pose_q = z(W, 4)
        self.pose_q[:, 0] = 1.0


class ReferenceFrontend:
    """The reference frontend over one configuration. `cfg` holds
    max_features, num_levels, pyramid_scale, fast_threshold, frame_life,
    nn_match_ratio, best_percent, mutual_check, guided_match_radius,
    min_odom_translation, min_odom_rotation (radians), blur_sigma,
    detect_border; `calib` the frontend's calib dict."""

    def __init__(self, cfg: dict, calib: dict, device, lowp: bool = False):
        self.cfg = cfg
        self.rig = Rig(calib)
        self.dev = torch.device(device)
        self.lowp = lowp
        self.tables = _brief_tables(self.dev)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.dev)
        s = lambda v: torch.tensor(v, dtype=torch.float32, device=self.dev)
        self.F, self.P_l, self.P_r = f(self.rig.F), f(self.rig.P_left), f(self.rig.P_right)
        self.cam_R, self.cam_t = f(self.rig.cam_R), f(self.rig.cam_t)
        self.ratio, self.best = s(cfg["nn_match_ratio"]), s(cfg["best_percent"])
        self.padding, self.radius = s(2.0), s(cfg["guided_match_radius"])

    # ---- the odometry gate and the keyframe poses, on the host
    def keyframes(self, events):
        """events: ("odometry", t, (translation, quaternion)) and ("stereo",
        t, frame key) in the order the program received them. Returns one
        dict per keyframe: the frame key, timestamp, odometry, previous
        keyframe's odometry and the float32 world pose."""
        c = self.cfg
        init = None
        prev_t = prev_q = odom_t = odom_q = None
        stamp = 0.0
        out = []
        for kind, t, payload in events:
            if kind == "odometry":
                tr = np.asarray(payload[0], np.float64)
                q = q_normalize(np.asarray(payload[1], np.float64))
                if init is None:
                    init = (tr.copy(), q.copy())
                    prev_t, prev_q = tr.copy(), q.copy()
                odom_t, odom_q, stamp = tr, q, float(t)
                continue
            if init is None:
                continue
            moved = np.linalg.norm(prev_t - odom_t) > c["min_odom_translation"]
            if not moved and q_angle(prev_q, odom_q) <= c["min_odom_rotation"]:
                continue
            qi = q_inverse(init[1])
            pose_t = q_rotate(qi, odom_t - init[0])
            pose_q = q_multiply(odom_q, qi)
            qp = q_inverse(prev_q)
            out.append(dict(frame=payload, timestamp=stamp, odom_t=odom_t.copy(), odom_q=odom_q.copy(),
                            odom=(q_rotate(qp, odom_t - prev_t).astype(np.float32),
                                  q_multiply(odom_q, qp).astype(np.float32)),
                            prev_t=prev_t.copy(), prev_q=prev_q.copy(),
                            pose=np.concatenate([pose_t, pose_q]).astype(np.float32),
                            loc=pose_t.astype(np.float32), angle=pose_q.astype(np.float32)))
            prev_t, prev_q = odom_t.copy(), odom_q.copy()
        return out

    # ---- one keyframe's matching, gates, tracks and geometry
    def _step(self, win: Window, fid, l_kps, l_desc, l_valid, r_kps, r_desc, r_valid, pose):
        c = self.cfg
        K, W, dev = c["max_features"], c["frame_life"], self.dev
        idx, d1, d2 = hamming_top2(l_desc, r_desc, r_valid)
        s_matched = l_valid & (d1 < self.ratio * d2) & (d1 <= 256.0)
        r_idx = torch.where(s_matched, idx, 0)
        mr = r_kps[r_idx.long()]
        ones = torch.ones_like(l_kps[..., :1])
        res = torch.einsum("ni,ij,nj->n", torch.cat([l_kps, ones], -1), self.F, torch.cat([mr, ones], -1)).abs()
        keep = s_matched & (res <= win.threshold)
        n_cand = s_matched.sum(dtype=torch.int32)
        avg = torch.where(s_matched, res, 0.0).sum() / n_cand.clamp(min=1).to(torch.float32)
        new_thr = torch.where(n_cand > 0, avg + self.padding, win.threshold)
        perm = torch.argsort(torch.where(keep, 0, 1), stable=True)
        f_kps, f_desc, f_valid, f_r = l_kps[perm], l_desc[perm], keep[perm], mr[perm]
        n_feat = f_valid.sum(dtype=torch.int32)

        widx, wd1, wd2 = hamming_top2(win.desc.reshape(W * K, 8), f_desc, f_valid)
        best_idx, wd1, wd2 = widx.reshape(W, K), wd1.reshape(W, K), wd2.reshape(W, K)
        matched = win.valid & (wd1 < self.ratio * wd2) & (wd1 <= 256.0)
        wkeep = best_percent(torch.where(matched, wd1, LARGE), matched, self.best)
        if c["mutual_check"]:
            tgt = torch.where(wkeep, best_idx, K).to(torch.int64)
            flat = (tgt + torch.arange(W, device=dev)[:, None] * (K + 1)).reshape(-1)
            dm = torch.where(wkeep, wd1, LARGE).reshape(-1)
            mn = torch.full((W * (K + 1),), LARGE, dtype=wd1.dtype, device=dev)
            mn = mn.scatter_reduce(0, flat, dm, reduce="amin", include_self=True)
            wkeep = wkeep & (wd1 <= mn[flat].reshape(W, K))
        w_idx = torch.where(wkeep, best_idx, 0)
        w_dist = torch.where(wkeep, wd1, LARGE)
        w_matched = wkeep
        w_idx_l = w_idx.long()
        lu = undistort(self.rig.il, f_kps, self.lowp)

        pose_t, pose_q = pose[:3], pose[3:]
        Rw = quat_matrix(win.pose_q)
        p_robot = torch.einsum("ij,wkj->wki", self.cam_R, win.points3d) + self.cam_t
        X = torch.einsum("wij,wkj->wki", Rw, p_robot) + win.pose_t[:, None]
        Rc = quat_matrix(pose_q)
        xr = torch.einsum("ji,wkj->wki", Rc, X - pose_t)
        pc = torch.einsum("ji,wkj->wki", self.cam_R, xr - self.cam_t)
        z = pc[..., 2]
        zs = torch.where(z.abs() < 1e-6, 1e-6, z)
        il = self.rig.il
        pu = il["fx"] * pc[..., 0] / zs + il["cx"]
        pv = il["fy"] * pc[..., 1] / zs + il["cy"]
        tgt_px = lu[w_idx_l]
        err2 = (pu - tgt_px[..., 0]) ** 2 + (pv - tgt_px[..., 1]) ** 2
        stored = win.points3d[..., 2] > 0.1
        ok = ((err2 <= self.radius ** 2) | ~(stored & (z > 0.1))) & ~(stored & (z <= 0.0))
        w_matched = w_matched & torch.where(self.radius > 0, ok, torch.ones_like(ok))

        tid = fid * K + torch.arange(K, dtype=torch.int32, device=dev)
        prio = torch.arange(W, dtype=torch.float32, device=dev)[:, None] * 1000.0 + w_dist.clamp(max=999.0)
        tg = torch.where(w_matched, w_idx_l, K).reshape(-1)
        minp = torch.full((K + 1,), float("inf"), device=dev).scatter_reduce(
            0, tg, prio.reshape(-1), reduce="amin", include_self=True)
        winner = w_matched & (prio == minp[tg].reshape(W, K))
        wt = torch.where(winner, w_idx_l, K).reshape(-1)
        src = torch.full((K + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, wt, torch.arange(W * K, device=dev), reduce="amax", include_self=True)[:K]
        tid = torch.where(src >= 0, win.track_id.reshape(-1)[src.clamp(min=0)], tid)

        ru = undistort(self.rig.ir, f_r, self.lowp)
        pts = torch.where(f_valid[:, None], triangulate(self.P_l, self.P_r, lu, ru, self.lowp), 0.0)
        out = dict(n=n_feat, pixels=torch.where(f_valid[:, None], lu, 0.0),
                   right=torch.where(f_valid[:, None], ru, 0.0), points=pts, track_id=tid,
                   w_idx=w_idx, w_matched=w_matched, w_frame=win.frame_id.clone())

        full = win.count >= W
        sel = torch.arange(W, device=dev) == win.count.clamp(max=W - 1)

        def upd(buf, row):
            rolled = torch.where(full, torch.roll(buf, -1, dims=0), buf)
            return torch.where(sel.reshape((W,) + (1,) * (buf.dim() - 1)), row.to(buf.dtype).unsqueeze(0), rolled)

        win.kps, win.desc, win.valid = upd(win.kps, f_kps), upd(win.desc, f_desc), upd(win.valid, f_valid)
        win.track_id, win.points3d = upd(win.track_id, tid), upd(win.points3d, pts)
        win.frame_id = upd(win.frame_id, torch.full((), fid, dtype=torch.int32, device=dev))
        win.count = (win.count + 1).clamp(max=W)
        win.threshold = new_thr
        win.pose_t, win.pose_q = upd(win.pose_t, pose_t), upd(win.pose_q, pose_q)
        return out, (n_cand, r_valid.sum())

    def run(self, keyframes, frame_images, batch: int = 16, record_levels=None):
        """Every keyframe's results, on the host. `frame_images(key)` gives
        the (left, right) uint8 arrays of a frame key; `record_levels` (a
        set of keyframe indices) keeps those keyframes' per-level keypoints
        for the roofline readers. Returns (results list, final Window)."""
        c = self.cfg
        K, W = c["max_features"], c["frame_life"]
        win = Window(W, K, 10000.0, self.dev)
        results = []
        for b0 in range(0, len(keyframes), batch):
            chunk = keyframes[b0:b0 + batch]
            imgs = [frame_images(kf["frame"]) for kf in chunk]
            stack = torch.from_numpy(np.stack([x for pair in imgs for x in pair])).to(self.dev)
            kps, desc, valid, levels = extract(stack, c, self.tables, self.lowp, keep_levels=record_levels is not None)
            for j, kf in enumerate(chunk):
                fid = b0 + j
                pose = torch.from_numpy(kf["pose"]).to(self.dev)
                out, (n_cand, n_right) = self._step(win, fid, kps[2 * j], desc[2 * j], valid[2 * j],
                                                    kps[2 * j + 1], desc[2 * j + 1], valid[2 * j + 1], pose)
                n = int(out["n"])
                host = dict(n=n, pixels=out["pixels"][:n].cpu().numpy(), right=out["right"][:n].cpu().numpy(),
                            points=out["points"][:n].cpu().numpy(), track_id=out["track_id"][:n].cpu().numpy(),
                            w_idx=out["w_idx"].cpu().numpy(), w_matched=out["w_matched"].cpu().numpy(),
                            w_frame=out["w_frame"].cpu().numpy(), n_right_valid=int(n_right),
                            n_left_valid=int(valid[2 * j].sum()))
                if record_levels is not None and fid in record_levels:
                    host["levels"] = [[(lk[2 * j + s].cpu().numpy(), lv[2 * j + s].cpu().numpy()) for lk, lv in levels]
                                      for s in (0, 1)]
                results.append(host)
        return results, win
