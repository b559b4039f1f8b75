"""Photometric degradation model for synthetic imagery (port of io/degrade.py).

A deterministic camera-nuisance model applied between the renderer and the
JPEG/bag/decode path, so accuracy pins are held on degraded, decoded imagery
rather than noiseless in-memory floats. The same seed gives arrays equal to
the JAX package's.

Effects (all deterministic in (seed, frame_index)):
  - exposure flicker: per-frame gain in [1-a, 1+a] + offset drift (auto-
    exposure hunting);
  - motion blur: per-frame directional 1-D blur (random heading, 0..max px);
  - vignetting: fixed radial falloff (lens shading);
  - sensor noise: signal-dependent shot noise + Gaussian read noise
    (the affine noise model sigma^2 = a*I + b).
"""

from __future__ import annotations

import numpy as np


def _directional_blur(img: np.ndarray, length: float, angle: float) -> np.ndarray:
    """1-D motion blur: average `n` unit-spaced bilinear taps along `angle`."""
    n = int(round(length))
    if n <= 1:
        return img
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dx, dy = np.cos(angle), np.sin(angle)
    acc = np.zeros_like(img, np.float32)
    for i in range(n):
        t = i - 0.5 * (n - 1)
        x = np.clip(xs + t * dx, 0, W - 1)
        y = np.clip(ys + t * dy, 0, H - 1)
        x0 = np.floor(x).astype(np.int32)
        y0 = np.floor(y).astype(np.int32)
        x1 = np.minimum(x0 + 1, W - 1)
        y1 = np.minimum(y0 + 1, H - 1)
        fx = x - x0
        fy = y - y0
        acc += (
            img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy
            + img[y1, x1] * fx * fy
        )
    return acc / n


class Degrader:
    """Deterministic per-frame photometric nuisance.

    Same (seed, frame_idx) -> same degradation, independent of call order,
    so fixtures regenerate exactly.
    """

    def __init__(
        self,
        seed: int = 0,
        flicker: float = 0.15,
        offset_drift: float = 8.0,
        max_blur_px: float = 3.5,
        noise_read: float = 2.5,
        noise_shot: float = 0.04,
        vignette: float = 0.25,
    ):
        self.seed = seed
        self.flicker = flicker
        self.offset_drift = offset_drift
        self.max_blur_px = max_blur_px
        self.noise_read = noise_read
        self.noise_shot = noise_shot
        self.vignette = vignette
        self._vig_cache: dict[tuple, np.ndarray] = {}

    def _vignette_map(self, shape) -> np.ndarray:
        if shape not in self._vig_cache:
            H, W = shape
            ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
            r2 = ((xs - W / 2) / (W / 2)) ** 2 + ((ys - H / 2) / (H / 2)) ** 2
            self._vig_cache[shape] = 1.0 - self.vignette * 0.5 * r2
        return self._vig_cache[shape]

    def __call__(self, img: np.ndarray, frame_idx: int, cam: int = 0) -> np.ndarray:
        """Degrade one frame. `cam` distinguishes left(0)/right(1) so the two
        cameras see independent noise but the SAME exposure state (they share
        the auto-exposure controller on a real rig)."""
        rng_exp = np.random.default_rng((self.seed, frame_idx, 7))
        rng_pix = np.random.default_rng((self.seed, frame_idx, cam, 11))
        x = img.astype(np.float32)

        # Motion blur (shared direction per frame — the rig moves as one).
        blur_len = rng_exp.uniform(1.0, self.max_blur_px)
        blur_ang = rng_exp.uniform(0, np.pi)
        x = _directional_blur(x, blur_len, blur_ang)

        # Vignetting.
        x = x * self._vignette_map(x.shape)

        # Exposure flicker: gain + offset, shared across the stereo pair.
        gain = 1.0 + rng_exp.uniform(-self.flicker, self.flicker)
        offset = rng_exp.uniform(-self.offset_drift, self.offset_drift)
        x = gain * x + offset

        # Affine sensor noise: sigma^2 = shot * I + read^2.
        sigma = np.sqrt(self.noise_shot * np.maximum(x, 0.0) + self.noise_read**2)
        x = x + rng_pix.normal(0.0, 1.0, x.shape).astype(np.float32) * sigma

        return np.clip(x, 0.0, 255.0)


def write_degraded_bag(
    path: str,
    rig=None,
    num_frames: int = 100,
    odom_drift: float = 0.02,
    jpeg_quality: int = 88,
    yaw_rate: float = None,
    seed: int = 9,
    step: float = 0.25,
    seq_seed: int = 5,
):
    """Render -> degrade -> JPEG -> ROS bag; returns {timestamp: gt_cam_pos}.

    The fixture of the degraded-bag golden pins and of the end-to-end bag
    rate: a stand-in for a real robot's stereo bag.

    `seed` controls only the photometric-degradation RNG; the rendered
    scene/trajectory is pinned by `seq_seed` so the same world can be
    degraded differently (vary `seq_seed` to get a different world).
    """
    from vision_slam_frontend_tpu_torch.io import rosbag
    from vision_slam_frontend_tpu_torch.io.image import encode_jpeg
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    if rig is None:
        rig = SyntheticRig()
    if yaw_rate is None:
        yaw_rate = 2 * np.pi / 210
    deg = Degrader(seed=seed)
    gt = {}
    with rosbag.BagWriter(path) as bag:
        conn_l = bag.get_connection(
            "/stereo/left/image_raw/compressed", "sensor_msgs/CompressedImage", "*", ""
        )
        conn_r = bag.get_connection(
            "/stereo/right/image_raw/compressed", "sensor_msgs/CompressedImage", "*", ""
        )
        conn_o = bag.get_connection("/odometry/filtered", "nav_msgs/Odometry", "*", "")
        frames = generate_sequence(
            num_frames=num_frames, step=step, rig=rig,
            yaw_rate=yaw_rate, odom_drift=odom_drift, seed=seq_seed,
        )
        for i, f in enumerate(frames):
            gt[round(f.timestamp, 6)] = f.cam_pos.copy()
            t_ns = int(f.timestamp * 1e9) + 1
            bag.write(
                conn_o, t_ns,
                rosbag.serialize_odometry(i, t_ns, f.odom_translation, f.odom_rotation),
            )
            for conn, img, cam in ((conn_l, f.left, 0), (conn_r, f.right, 1)):
                bag.write(
                    conn, t_ns,
                    rosbag.serialize_compressed_image(
                        i, t_ns, "jpeg",
                        encode_jpeg(deg(img, i, cam=cam), quality=jpeg_quality),
                    ),
                )
    return gt
