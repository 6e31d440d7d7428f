"""Self-contained interactive scene viewer (single HTML file, zero deps).

A copy of ``lsdm_tpu/utils/html_viewer.py`` (numpy and JSON only; the
port imports nothing of the JAX package): the same page and the same
embedded ``DATA`` for the same inputs.

Replaces the reference's open3d interactive window
(``vis_fitting_results.py:11-71``) in a way that works from a headless
machine: the scene data is embedded as JSON in one .html file with a small
canvas renderer (orbit by mouse drag, wheel zoom, frame scrubbing for the
human motion sequence) — open it in any browser, no server, no internet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lsdm_tpu scene</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:10px;user-select:none}
#frame{width:260px;vertical-align:middle}
canvas{display:block}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; frame
<input id="frame" type="range" min="0" value="0" step="1">
<span id="fno">0</span></div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
const slider = document.getElementById("frame"), fno = document.getElementById("fno");
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener("resize", rs);
let yaw = 0.7, pitch = 0.4, dist = 3.2, frame = 0;
slider.max = Math.max(DATA.frames.length - 1, 0);
slider.oninput = () => {frame = +slider.value; fno.textContent = frame; draw();};
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => { if (!drag) return;
  yaw += (e.clientX - drag[0]) * .008; pitch += (e.clientY - drag[1]) * .008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch)); drag = [e.clientX, e.clientY]; draw();});
cv.onwheel = e => {dist *= Math.exp(e.deltaY * .001); draw(); e.preventDefault();};
function proj(p, cy, sy, cp, sp) {
  const x = p[0] - DATA.center[0], y = p[1] - DATA.center[1], z = p[2] - DATA.center[2];
  const x1 = cy * x + sy * z, z1 = -sy * x + cy * z;
  const y2 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist * DATA.radius;
  if (z2 <= .05) return null;
  const f = .9 * Math.min(W, H) / z2;
  return [W / 2 + f * x1, H / 2 - f * y2, z2];
}
function cloud(points, color, size, cy, sy, cp, sp, palette) {
  ctx.fillStyle = color;
  for (const p of points) { const q = proj(p, cy, sy, cp, sp);
    if (!q) continue;
    if (palette && p.length > 3) ctx.fillStyle = palette[p[3] % palette.length];
    ctx.fillRect(q[0] - size / 2, q[1] - size / 2, size, size); }
}
function wire(verts, edges, color, cy, sy, cp, sp) {
  ctx.strokeStyle = color; ctx.beginPath();
  for (const [a, b] of edges) {
    const p = proj(verts[a], cy, sy, cp, sp), q = proj(verts[b], cy, sy, cp, sp);
    if (p && q) { ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]); } }
  ctx.stroke();
}
function draw() {
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  ctx.fillStyle = "#111"; ctx.fillRect(0, 0, W, H);
  for (const o of DATA.objects)
    o.edges ? wire(o.verts, o.edges, o.color, cy, sy, cp, sp)
            : cloud(o.verts, o.color, 2.5, cy, sy, cp, sp);
  if (DATA.frames.length)
    cloud(DATA.frames[frame], "#6cf", 2, cy, sy, cp, sp, DATA.palette);
}
rs();
</script></body></html>
"""


def _mesh_edges(faces: np.ndarray, limit: int = 6000) -> List[List[int]]:
    edges = set()
    for f in np.asarray(faces, int).tolist():
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges.add((min(a, b), max(a, b)))
            if len(edges) >= limit:
                return [list(e) for e in edges]
    return [list(e) for e in edges]


def write_scene_html(
    path: str,
    frames: Optional[np.ndarray] = None,  # (T, V, 3) human sequence
    objects: Sequence[Dict] = (),  # {verts (V,3), faces (F,3)?, color?}
    max_points: int = 4000,
    frame_labels: Optional[np.ndarray] = None,  # (T, V) int classes
    palette: Optional[Sequence[str]] = None,  # colors indexed by label
):
    """Write a standalone interactive viewer.  Point sets are subsampled to
    ``max_points`` per frame/object to keep the file small.  When
    ``frame_labels``/``palette`` are given, each frame point carries its
    integer class as a 4th component and is drawn in ``palette[label]``
    (the dataset viewer's contact-semantics coloring)."""

    def sub(v, labels=None):
        v = np.asarray(v, np.float32).reshape(-1, 3)
        idx = None
        if len(v) > max_points:
            idx = np.linspace(0, len(v) - 1, max_points).astype(int)
            v = v[idx]
        v = np.round(v, 4)
        if labels is not None:
            lab = np.asarray(labels, np.float32).reshape(-1)
            if idx is not None:
                lab = lab[idx]
            v = np.concatenate([v, lab[:, None]], axis=1)
        return v.tolist()

    objs = []
    all_pts = []
    obj_palette = ["#fa5", "#5fa", "#f5a", "#af5", "#a5f", "#5af"]
    for i, o in enumerate(objects):
        verts = np.asarray(o["verts"], np.float32).reshape(-1, 3)
        all_pts.append(verts)
        entry = {"verts": sub(verts),
                 "color": o.get("color", obj_palette[i % len(obj_palette)])}
        if o.get("faces") is not None and len(entry["verts"]) == len(verts):
            entry["edges"] = _mesh_edges(o["faces"])
        objs.append(entry)

    frame_list = []
    if frames is not None:
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        labs = (None,) * len(frames)
        if frame_labels is not None:
            labs = np.asarray(frame_labels)
            if labs.ndim == 1:
                labs = labs[None]
        frame_list = [sub(f, lb) for f, lb in zip(frames, labs)]
        all_pts.append(frames.reshape(-1, 3))

    pts = (np.concatenate(all_pts, axis=0) if all_pts
           else np.zeros((1, 3), np.float32))
    center = pts.mean(axis=0)
    radius = float(max(np.linalg.norm(pts - center, axis=1).max(), 1e-3))

    data = {"objects": objs, "frames": frame_list,
            "palette": (list(palette) if palette else None),
            "center": np.round(center, 4).tolist(), "radius": radius}
    with open(path, "w") as f:
        f.write(_TEMPLATE.replace("__DATA__", json.dumps(data)))
    return path
