"""Self-contained interactive HTML viewer for the pose graph + landmark cloud
(port of viz/html.py).

One HTML file, no server, no dependencies: a canvas 3D point/line renderer
with orbit controls, embedding the problem as JSON, in the reference's RViz
colors (red pose nodes, green odometry edges, blue vision edges, white
landmarks). The text equals the JAX package's for the same problem.
"""

from __future__ import annotations

import json

import numpy as np

from vision_slam_frontend_tpu_torch.types.slam_types import SLAMProblem
from vision_slam_frontend_tpu_torch.viz.ply import landmark_points_world

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>SLAM viewer</title>{refresh_tag}
<style>
 body {{ margin:0; background:#111; color:#ccc; font:12px monospace; overflow:hidden }}
 #hud {{ position:fixed; top:8px; left:8px; z-index:2; user-select:none }}
 canvas {{ display:block }}
</style></head>
<body>
<div id="hud">{title}<br>{stats}<br>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = -0.6, pitch = 0.5, dist = DATA.extent * 2.5, cx = DATA.center, pan = [0, 0];
// Live mode reloads the page; keep the camera across reloads.
try {{
  const s = JSON.parse(localStorage.getItem('vsf_cam') || 'null');
  if (s) {{ yaw = s[0]; pitch = s[1]; dist = s[2]; pan = s[3]; }}
}} catch (e) {{}}
function saveCam() {{
  try {{ localStorage.setItem('vsf_cam', JSON.stringify([yaw, pitch, dist, pan])); }} catch (e) {{}}
}}
addEventListener('beforeunload', saveCam);
setInterval(saveCam, 500);
function resize() {{ canvas.width = innerWidth; canvas.height = innerHeight; draw(); }}
addEventListener('resize', resize);
let drag = null;
canvas.addEventListener('mousedown', e => drag = [e.clientX, e.clientY, e.shiftKey]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ pan[0] += dx * dist / 600; pan[1] += dy * dist / 600; }}
  else {{ yaw += dx * 0.008; pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * 0.008)); }}
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
}});
canvas.addEventListener('wheel', e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); }});
function project(p) {{
  const x = p[0] - cx[0], y = p[1] - cx[1], z = p[2] - cx[2];
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy_ * x + sy * z, z1 = -sy * x + cy_ * z;
  const y2 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist;
  if (z2 < 0.01) return null;
  const f = 0.9 * Math.min(canvas.width, canvas.height) / z2;
  return [canvas.width / 2 + x1 * f + pan[0], canvas.height / 2 + y2 * f + pan[1], z2];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  // landmarks
  ctx.fillStyle = 'rgba(255,255,255,0.55)';
  for (const p of DATA.landmarks) {{
    const s = project(p); if (!s) continue;
    ctx.fillRect(s[0], s[1], 1.6, 1.6);
  }}
  // edges
  function edges(list, color) {{
    ctx.strokeStyle = color; ctx.lineWidth = 1; ctx.beginPath();
    for (const [i, j] of list) {{
      const a = project(DATA.nodes[i]), b = project(DATA.nodes[j]);
      if (!a || !b) continue;
      ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    }}
    ctx.stroke();
  }}
  edges(DATA.vision_edges, 'rgba(80,120,255,0.35)');
  edges(DATA.odom_edges, 'rgba(60,220,60,0.9)');
  // nodes
  ctx.fillStyle = '#ff4040';
  for (const p of DATA.nodes) {{
    const s = project(p); if (!s) continue;
    ctx.fillRect(s[0] - 2, s[1] - 2, 4, 4);
  }}
}}
resize();
</script></body></html>
"""


def export_html(
    path: str,
    problem: SLAMProblem,
    left_cam_to_robot: np.ndarray | None = None,
    max_landmarks: int = 60000,
    title: str = "vision_slam_frontend_tpu",
    refresh_seconds: float | None = None,
) -> dict:
    """Write a standalone interactive HTML viewer. Returns content stats.

    With `refresh_seconds`, the page reloads itself on that period (camera
    kept in localStorage), so a writer that rewrites the file per keyframe
    is followed by an open browser tab. The file is written atomically (tmp
    + rename), so a reload never sees a torn page."""
    if left_cam_to_robot is None:
        left_cam_to_robot = np.eye(4)
    nodes = np.array([n.pose.loc for n in problem.nodes], np.float64).reshape(-1, 3)
    landmarks = landmark_points_world(problem, left_cam_to_robot)
    if len(landmarks) > max_landmarks:
        idx = np.linspace(0, len(landmarks) - 1, max_landmarks).astype(int)
        landmarks = landmarks[idx]
    id_to_row = {n.node_idx: i for i, n in enumerate(problem.nodes)}
    odom_edges = [
        [id_to_row[f.pose_i], id_to_row[f.pose_j]] for f in problem.odometry_factors
    ]
    vision_edges = [
        [id_to_row[f.pose_idx_initial], id_to_row[f.pose_idx_current]]
        for f in problem.vision_factors
    ]
    pts = np.concatenate([nodes, landmarks]) if len(landmarks) else nodes
    center = pts.mean(axis=0) if len(pts) else np.zeros(3)
    extent = float(np.max(np.linalg.norm(pts - center, axis=-1))) if len(pts) else 1.0
    data = {
        "nodes": np.round(nodes, 4).tolist(),
        "landmarks": np.round(landmarks, 3).tolist(),
        "odom_edges": odom_edges,
        "vision_edges": vision_edges,
        "center": np.round(center, 3).tolist(),
        "extent": max(extent, 1e-3),
    }
    stats = {
        "nodes": len(nodes),
        "landmarks": len(landmarks),
        "odom_edges": len(odom_edges),
        "vision_edges": len(vision_edges),
    }
    refresh_tag = (
        f'<meta http-equiv="refresh" content="{refresh_seconds:g}">'
        if refresh_seconds else ""
    )
    html = _TEMPLATE.format(
        data=json.dumps(data),
        title=title,
        refresh_tag=refresh_tag,
        stats=f"{stats['nodes']} poses · {stats['landmarks']} landmarks · "
        f"{stats['odom_edges']} odom + {stats['vision_edges']} vision edges",
    )
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
    return stats
