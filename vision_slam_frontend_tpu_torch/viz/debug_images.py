"""Debug match/stereo images, drawn on the host in numpy (port of
viz/debug_images.py; the same bytes from the same arrays).

The stereo image is left|right concatenated with red circles on matched
keypoints and a line across each pair; the temporal match image is the
current frame with red circles at the past frame's feature positions and
green flow lines to the current positions. Each stereo line's colour comes
from `np.random.default_rng(i)`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(img, np.float32), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Integer line via dense interpolation (numpy, no cv2 dependency)."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.clip(np.linspace(x0, x1, n).round().astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.linspace(y0, y1, n).round().astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = color


def _draw_circle(img: np.ndarray, center, radius, color) -> None:
    cx, cy = float(center[0]), float(center[1])
    th = np.linspace(0, 2 * np.pi, 8 * radius)
    xs = np.clip((cx + radius * np.cos(th)).round().astype(int), 0, img.shape[1] - 1)
    ys = np.clip((cy + radius * np.sin(th)).round().astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = color


def _line_color(i: int) -> tuple:
    """Deterministic per-match colour."""
    rng = np.random.default_rng(i)
    return tuple(int(v) for v in rng.integers(64, 255, 3))


def create_stereo_debug_image(
    left_image: np.ndarray,
    right_image: np.ndarray,
    left_points: np.ndarray,
    right_points: np.ndarray,
) -> np.ndarray:
    """left|right concatenation with matched pairs circled and connected."""
    li = _to_rgb(left_image)
    ri = _to_rgb(right_image)
    h = max(li.shape[0], ri.shape[0])
    canvas = np.zeros((h, li.shape[1] + ri.shape[1], 3), np.uint8)
    canvas[: li.shape[0], : li.shape[1]] = li
    canvas[: ri.shape[0], li.shape[1] :] = ri
    off = li.shape[1]
    red = (255, 0, 0)
    for i, (lp, rp) in enumerate(zip(left_points, right_points)):
        rp_off = (rp[0] + off, rp[1])
        _draw_circle(canvas, lp, 5, red)
        _draw_circle(canvas, rp_off, 5, red)
        _draw_line(canvas, lp, rp_off, _line_color(i))
    return canvas


def create_match_debug_image(
    current_image: np.ndarray,
    initial_points: np.ndarray,
    current_points: np.ndarray,
) -> np.ndarray:
    """Current frame with past-feature circles and flow lines."""
    canvas = _to_rgb(current_image)
    red = (255, 0, 0)
    green = (0, 255, 0)
    for ip, cp in zip(initial_points, current_points):
        _draw_circle(canvas, ip, 5, red)
        _draw_line(canvas, ip, cp, green)
    return canvas


def render_debug_entry(entry: dict, nodes_by_id: dict):
    """Render one keyframe's debug images: (stereo_image, match_image|None).

    `entry` is the Frontend's per-keyframe debug dict (frame_id, left_image,
    right_image, result: a KeyframeResult of host arrays); `nodes_by_id`
    maps node_idx -> SLAMNode for the temporal-match drawing."""
    r = entry["result"]
    n = int(r.num_features)
    lp = np.asarray(r.pixels_raw[:n])
    rp = np.asarray(r.right_pixels_raw[:n])
    stereo = create_stereo_debug_image(
        entry["left_image"], entry["right_image"], lp, rp
    )
    # Temporal matches against the newest filled window slot (the most
    # recent past frame).
    w_ids = np.asarray(r.window_frame_id)
    filled = np.nonzero(w_ids >= 0)[0]
    if len(filled) == 0:
        return stereo, None
    w = int(filled[-1])
    past = nodes_by_id.get(int(w_ids[w]))
    matched = np.asarray(r.window_matched[w])
    qs = np.nonzero(matched)[0]
    if past is None or len(qs) == 0:
        return stereo, None
    ip = np.array([past.features[q].pixel for q in qs if q < len(past.features)])
    cp = np.array(
        [
            np.asarray(r.pixels_raw[int(r.window_curr_idx[w][q])])
            for q in qs
            if q < len(past.features)
        ]
    )
    if not len(ip):
        return stereo, None
    return stereo, create_match_debug_image(entry["left_image"], ip, cp)


def debug_images_from_frontend(frontend) -> tuple[list, list]:
    """(match_images, stereo_images) of a Frontend's buffered debug data."""
    match_images = []
    stereo_images = []
    problem = frontend.get_slam_problem()
    nodes_by_id = {n.node_idx: n for n in problem.nodes}
    for entry in frontend.get_debug_data():
        stereo, match = render_debug_entry(entry, nodes_by_id)
        stereo_images.append(stereo)
        if match is not None:
            match_images.append(match)
    return match_images, stereo_images
