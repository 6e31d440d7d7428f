"""Render fitted scenes to frames (reference ``vis_fitting_results.py``):
fitted objects + per-frame human mesh -> ``rendering/frame_%04d.png``.

Counterpart of ``lsdm_tpu/run/vis_fitting_results.py``, with its flags,
on the port's ``fitting/meshio.py`` and ``utils/html_viewer.py``: host
only, it reads the ``fit_best_obj/**/opt_best.obj`` meshes that the
fitting runners write.  matplotlib is imported only to write PNGs
(``--no_png`` needs none).

    python -m lsdm_tpu_torch.run.vis_fitting_results \\
        --fitting_results_path fitting_results --vertices_path V.npy \\
        [--faces_path F.npy] [--no_png] [--html]

open3d's interactive window is replaced with (a) a headless matplotlib 3D
render (point/wireframe), (b) per-frame combined PLY for external viewers,
and (c) ``--html``: a standalone interactive orbit viewer in one file
(``utils/html_viewer.py``) — the interactive capability without a GUI
environment.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Write the frames (and ``scene.html``); returns the output folder."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fitting_results_path", required=True)
    ap.add_argument("--vertices_path", required=True)
    ap.add_argument("--faces_path", default=None)
    ap.add_argument("--every", type=int, default=8)
    ap.add_argument("--max_frames", type=int, default=50)
    ap.add_argument("--no_png", action="store_true", help="PLY export only")
    ap.add_argument("--html", action="store_true",
                    help="also write a standalone interactive scene.html "
                         "(replaces the reference's open3d window, "
                         "utils/html_viewer.py)")
    args = ap.parse_args(argv)

    import numpy as np

    from lsdm_tpu_torch.fitting.meshio import load_obj, merge_meshes, write_ply

    fit_dir = Path(args.fitting_results_path) / "fit_best_obj"
    objs = []
    if fit_dir.exists():
        for mesh_path in fit_dir.glob("**/opt_best.obj"):
            objs.append(load_obj(str(mesh_path)))
    print(f"{len(objs)} fitted objects")

    verts = np.load(args.vertices_path).astype(np.float32)
    if verts.ndim == 2:
        verts = verts[None]
    verts = verts[:: args.every][: args.max_frames]
    faces = None
    if args.faces_path:
        if args.faces_path.endswith(".obj"):
            _, faces = load_obj(args.faces_path)
        else:
            faces = np.load(args.faces_path).astype(np.int32)

    out_dir = Path(args.fitting_results_path) / "rendering"
    out_dir.mkdir(parents=True, exist_ok=True)

    obj_v, obj_f = merge_meshes(objs) if objs else (np.zeros((0, 3)), None)

    if not args.no_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

    for t, hv in enumerate(verts):
        scene_v, scene_f = merge_meshes(
            [(obj_v, obj_f if obj_f is not None and len(obj_f) else None),
             (hv, faces)]
        )
        write_ply(str(out_dir / f"frame_{t:04d}.ply"), scene_v, scene_f)
        if not args.no_png:
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(projection="3d")
            if len(obj_v):
                ax.scatter(obj_v[:, 0], obj_v[:, 1], obj_v[:, 2], s=1, c="tab:blue",
                           alpha=0.5)
            ax.scatter(hv[:, 0], hv[:, 1], hv[:, 2], s=1, c="tab:orange")
            ax.set_box_aspect((1, 1, 1))
            ax.view_init(elev=20, azim=45)
            fig.savefig(out_dir / f"frame_{t:04d}.png", dpi=80)
            plt.close(fig)
    if args.html:
        from lsdm_tpu_torch.utils.html_viewer import write_scene_html

        objects = [{"verts": v, "faces": f} for v, f in objs]
        write_scene_html(str(out_dir / "scene.html"), frames=verts,
                         objects=objects)
        print(f"interactive viewer: {out_dir / 'scene.html'}")
    print(f"wrote {len(verts)} frames to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
