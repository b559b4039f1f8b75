"""Live (per-keyframe) visualization, the headless RViz equivalent (port of
viz/live.py: the same page, the same delta chunks, the same PNG names).

The reference publishes the pose graph, landmark cloud, and debug images to
RViz after every keyframe (reference: src/slam_frontend_main.cc:194-225
PublishVisualization, :295-309 debug image topics, publishers :252-259).
This framework runs headless, so the live surface is files:

  - LiveViewer: atomically rewrites one self-refreshing HTML viewer per
    keyframe — open it in any browser and watch the map grow (camera
    persists across the auto-reloads via localStorage).
  - DebugImageStreamer: a Frontend debug sink that renders and writes each
    keyframe's stereo/match debug images to disk AS THEY HAPPEN, instead of
    buffering every raw stereo pair in RAM for the whole run. Memory stays
    flat.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class LiveViewer:
    """Rewrite an auto-refreshing HTML pose-graph viewer every few keyframes.

    Usage:
        viewer = LiveViewer("/tmp/run_live.html", cam_to_robot, every=1)
        ... per keyframe: viewer.update(frontend.get_slam_problem())
    """

    def __init__(
        self,
        path: str,
        left_cam_to_robot: Optional[np.ndarray] = None,
        every: int = 1,
        refresh_seconds: float = 2.0,
        max_landmarks: int = 60000,
        title: str = "vision_slam_frontend_tpu (live)",
    ):
        self.path = path
        self.left_cam_to_robot = left_cam_to_robot
        self.every = max(1, int(every))
        self.refresh_seconds = refresh_seconds
        self.max_landmarks = max_landmarks
        self.title = title
        self._updates = 0
        self.last_stats: dict = {}

    def update(self, problem, force: bool = False) -> Optional[dict]:
        """Rewrite the viewer if this is an every-Kth update (or force=True).

        Returns the content stats when a write happened, else None."""
        self._updates += 1
        if not force and (self._updates - 1) % self.every:
            return None
        from vision_slam_frontend_tpu_torch.viz.html import export_html

        self.last_stats = export_html(
            self.path,
            problem,
            left_cam_to_robot=self.left_cam_to_robot,
            max_landmarks=self.max_landmarks,
            title=self.title,
            refresh_seconds=self.refresh_seconds,
        )
        return self.last_stats


_INCR_HEADER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<meta http-equiv="refresh" content="{refresh:g}">
<style>
 body {{ margin:0; background:#111; color:#ccc; font:12px monospace; overflow:hidden }}
 #hud {{ position:fixed; top:8px; left:8px; z-index:2; user-select:none }}
 #dbg {{ position:fixed; right:8px; bottom:8px; z-index:2; max-width:38vw;
        max-height:38vh; border:1px solid #333 }}
 canvas {{ display:block }}
</style></head>
<body>
<div id="hud">{title}<br><span id="stats"></span><br>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<img id="dbg" style="display:none">
<canvas id="c"></canvas>
<script>
// Incremental live viewer: the writer appends one <script>A({{...}})<\\u002fscript>
// chunk per keyframe batch (O(delta) writer cost); this header replays them
// on each auto-refresh. Node rows are keyed by node_idx via IDX.
const NODES = [], LANDMARKS = [], OE = [], VE = [], IDX = {{}};
let DBG = null, NKF = 0;
function A(d) {{
  for (const n of (d.nodes || [])) {{
    IDX[n.i] = NODES.length; NODES.push(n.p);
    for (const p of (n.lm || [])) LANDMARKS.push(p);
    NKF++;
  }}
  for (const e of (d.oe || [])) OE.push(e);
  for (const e of (d.ve || [])) VE.push(e);
  if (d.dbg) DBG = d.dbg;
}}
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = -0.6, pitch = 0.5, dist = 10, cx = [0, 0, 0], pan = [0, 0];
function saveCam() {{
  try {{ localStorage.setItem('vsf_cam', JSON.stringify([yaw, pitch, dist, pan])); }} catch (e) {{}}
}}
addEventListener('beforeunload', saveCam);
setInterval(saveCam, 500);
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
  ctx.fillStyle = 'rgba(255,255,255,0.55)';
  for (const p of LANDMARKS) {{
    const s = project(p); if (!s) continue;
    ctx.fillRect(s[0], s[1], 1.6, 1.6);
  }}
  function edges(list, color) {{
    ctx.strokeStyle = color; ctx.lineWidth = 1; ctx.beginPath();
    for (const [i, j] of list) {{
      const ri = IDX[i], rj = IDX[j];
      if (ri === undefined || rj === undefined) continue;
      const a = project(NODES[ri]), b = project(NODES[rj]);
      if (!a || !b) continue;
      ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    }}
    ctx.stroke();
  }}
  edges(VE, 'rgba(80,120,255,0.35)');
  edges(OE, 'rgba(60,220,60,0.9)');
  ctx.fillStyle = '#ff4040';
  for (const p of NODES) {{
    const s = project(p); if (!s) continue;
    ctx.fillRect(s[0] - 2, s[1] - 2, 4, 4);
  }}
}}
function resize() {{ canvas.width = innerWidth; canvas.height = innerHeight; draw(); }}
addEventListener('resize', resize);
// Deltas below run before this 'load' handler: finalize view after replay.
addEventListener('load', () => {{
  let c = [0, 0, 0];
  for (const p of NODES) {{ c[0] += p[0]; c[1] += p[1]; c[2] += p[2]; }}
  if (NODES.length) cx = c.map(v => v / NODES.length);
  let ext = 1;
  for (const p of NODES)
    ext = Math.max(ext, Math.hypot(p[0] - cx[0], p[1] - cx[1], p[2] - cx[2]));
  dist = ext * 2.5;
  try {{
    const s = JSON.parse(localStorage.getItem('vsf_cam') || 'null');
    if (s) {{ yaw = s[0]; pitch = s[1]; dist = s[2]; pan = s[3]; }}
  }} catch (e) {{}}
  document.getElementById('stats').textContent =
    NKF + ' poses · ' + LANDMARKS.length + ' landmarks · ' +
    OE.length + ' odom + ' + VE.length + ' vision edges';
  if (DBG) {{
    const im = document.getElementById('dbg');
    im.src = DBG + '?t=' + Date.now(); im.style.display = 'block';
  }}
  resize();
}});
</script>
"""


class IncrementalLiveViewer:
    """Append-only live viewer: O(delta) writer cost per keyframe.

    LiveViewer re-exports the whole problem every keyframe (O(N) writes,
    O(N^2) per run) and its caller's `get_slam_problem()` flushes the
    frontend's one-deep result pipeline. This viewer:

      - writes one static HTML header once, then APPENDS one small
        `<script>A({...})</script>` chunk per update (new nodes, their
        landmark points, new edges) — the page replays chunks on each
        auto-refresh (browser-side O(N), writer-side O(delta));
      - reads `frontend.peek_accumulated()` — the already-materialized
        accumulator, one keyframe behind the device — so pipelining survives
        with visualization on;
      - embeds the newest stereo/match debug image (from a DebugImageStreamer
        sink, if installed) in the live page — the reference's debug_image /
        debug_stereo_image live topics (src/slam_frontend_main.cc:295-309).

    Usage:
        viewer = IncrementalLiveViewer("/tmp/run_live.html", cam_to_robot)
        ... per keyframe: viewer.update(frontend)
    """

    def __init__(
        self,
        path: str,
        left_cam_to_robot: Optional[np.ndarray] = None,
        every: int = 1,
        refresh_seconds: float = 2.0,
        max_landmarks_per_node: int = 400,
        title: str = "vision_slam_frontend_tpu (live)",
    ):
        self.path = path
        self.left_cam_to_robot = (
            np.eye(4) if left_cam_to_robot is None else left_cam_to_robot
        )
        self.every = max(1, int(every))
        self.max_landmarks_per_node = max_landmarks_per_node
        self._updates = 0
        self._n_nodes = 0
        self._n_vf = 0
        self._n_of = 0
        self.last_stats: dict = {}
        header = _INCR_HEADER.format(title=title, refresh=refresh_seconds)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(header)
        os.replace(tmp, path)

    def update(self, frontend, force: bool = False) -> Optional[dict]:
        """Append new-content deltas if this is an every-Kth update.

        Returns the delta stats when a write happened, else None."""
        self._updates += 1
        if not force and (self._updates - 1) % self.every:
            return None
        import json

        from vision_slam_frontend_tpu_torch.viz.ply import node_landmarks_world

        nodes, vfs, ofs = frontend.peek_accumulated()
        new_nodes = nodes[self._n_nodes :]
        delta = {
            "nodes": [], "oe": [], "ve": [],
        }
        for n in new_nodes:
            lm = node_landmarks_world(n, self.left_cam_to_robot)
            if len(lm) > self.max_landmarks_per_node:
                idx = np.linspace(0, len(lm) - 1, self.max_landmarks_per_node)
                lm = lm[idx.astype(int)]
            delta["nodes"].append(
                {
                    "i": int(n.node_idx),
                    "p": np.round(np.asarray(n.pose.loc, np.float64), 4).tolist(),
                    "lm": np.round(lm, 3).tolist(),
                }
            )
        delta["oe"] = [
            [int(f.pose_i), int(f.pose_j)] for f in ofs[self._n_of :]
        ]
        delta["ve"] = [
            [int(f.pose_idx_initial), int(f.pose_idx_current)]
            for f in vfs[self._n_vf :]
        ]
        sink = getattr(frontend, "debug_sink", None)
        last_img = getattr(sink, "last_path", None)
        if last_img:
            delta["dbg"] = os.path.relpath(
                last_img, os.path.dirname(os.path.abspath(self.path))
            )
        self._n_nodes = len(nodes)
        self._n_of = len(ofs)
        self._n_vf = len(vfs)
        if not (delta["nodes"] or delta["oe"] or delta["ve"]):
            return None
        # One append per update; a reader catching a torn tail loses only the
        # newest chunk until the next refresh (earlier chunks stay intact).
        with open(self.path, "a") as f:
            f.write("<script>A(" + json.dumps(delta) + ")</script>\n")
        self.last_stats = {
            "new_nodes": len(delta["nodes"]),
            "new_odom_edges": len(delta["oe"]),
            "new_vision_edges": len(delta["ve"]),
            "total_nodes": self._n_nodes,
        }
        return self.last_stats


class DebugImageStreamer:
    """Frontend debug sink: render + write debug images per keyframe.

    Install with `frontend.debug_sink = DebugImageStreamer(dir)`; the
    frontend then hands each keyframe's debug entry here instead of
    buffering it (reference analogue: the per-keyframe debug_image /
    debug_stereo_image topics, src/slam_frontend_main.cc:295-309).
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.num_stereo = 0
        self.num_match = 0
        # Newest written image (match preferred over stereo): the live
        # viewer embeds this in the auto-refreshing page.
        self.last_path: Optional[str] = None

    def __call__(self, entry: dict, frontend) -> None:
        from PIL import Image

        from vision_slam_frontend_tpu_torch.viz.debug_images import render_debug_entry

        nodes_by_id = {n.node_idx: n for n in frontend._nodes}
        stereo, match = render_debug_entry(entry, nodes_by_id)
        fid = int(entry["frame_id"])
        spath = os.path.join(self.directory, f"stereo_{fid:05d}.png")
        Image.fromarray(stereo).save(spath)
        self.num_stereo += 1
        self.last_path = spath
        if match is not None:
            mpath = os.path.join(self.directory, f"match_{fid:05d}.png")
            Image.fromarray(match).save(mpath)
            self.num_match += 1
            self.last_path = mpath
