"""Headless POSA-temp dataset sequence viewer (reference
``posa/vis_dataset.py:15-111``).

Counterpart of ``lsdm_tpu/run/vis_dataset.py``, with its flags, on the
port's ``ops/rotations.py``, ``fitting/meshio.py`` and
``utils/html_viewer.py``: host only.  matplotlib is imported only to
write PNGs (``--no_png`` needs none).

The reference opens an interactive open3d window (or captures per-frame
screen images with ``--save_video``) showing a sequence's body mesh
colored by its per-vertex contact-semantics class, optionally composited
over the scene mesh, optionally in the canonical frame (rotated upright
by ``euler2mat(-pi/2, 0, 0, 'sxyz')``, ``posa/vis_dataset.py:73``).

This equivalent works with no GUI: per-frame PNG renders (matplotlib
Agg) named ``frame_%04d.png`` like the reference's video capture, plus
``--html`` — one standalone interactive orbit viewer with frame
scrubbing and the same contact-class coloring
(``utils/html_viewer.py``).

Disk layout consumed (same as the contact datasets, posa/dataset.py):
  <data_dir>/vertices/<seq>_verts.npy          (T, V, 3)
  <data_dir>/vertices_can/<seq>_verts_can.npy  (T, V, 3)
  <data_dir>/semantics/<seq>_cfs.npy           (T, V) int classes
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence

# mpcat40-flavored colors for the 8 contact classes (0 = no contact,
# drawn faint gray; the reference colors through posa/vis_utils
# show_sample's colormap)
CONTACT_PALETTE = ["#555555", "#e6194b", "#3cb44b", "#ffe119",
                   "#4363d8", "#f58231", "#911eb4", "#42d4f4"]


def _load_seq_file(data_dir: str, sub: str, seq: str, suffix: str):
    """Accept both naming conventions seen in the stack: the reference
    joins ``seq_name + "_verts.npy"`` (vis_dataset.py:57) while the
    contact loaders split on the bare suffix (``<seq>verts.npy``)."""
    import numpy as np

    for name in (f"{seq}_{suffix}.npy", f"{seq}{suffix}.npy"):
        p = os.path.join(data_dir, sub, name)
        if os.path.exists(p):
            return np.load(p)
    raise FileNotFoundError(
        f"no {sub}/{seq}[_]{suffix}.npy under {data_dir}")


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Render the sequence; returns the output folder."""
    ap = argparse.ArgumentParser(
        description="render a contact-dataset sequence headlessly")
    ap.add_argument("--data_dir", required=True,
                    help="POSA-temp dir with vertices/, vertices_can/, "
                         "semantics/")
    ap.add_argument("--seq_name", required=True)
    ap.add_argument("--save_dir", default=None,
                    help="output dir (default <data_dir>/vis/<seq_name>)")
    ap.add_argument("--every", type=int, default=5,
                    help="frame stride (the reference strides 5)")
    ap.add_argument("--max_frames", type=int, default=40)
    ap.add_argument("--single_frame", type=int, default=-1,
                    help="render only this frame index")
    ap.add_argument("--show_canonical", action="store_true",
                    help="canonical verts rotated upright instead of the "
                         "world-frame sequence (no scene mesh)")
    ap.add_argument("--scene_path", default=None,
                    help="optional scene mesh (.ply/.obj) composited "
                         "behind the body (reference: scene_dir/<scene>.ply)")
    ap.add_argument("--no_obj_classes", type=int, default=8)
    ap.add_argument("--no_png", action="store_true")
    ap.add_argument("--html", action="store_true",
                    help="also write an interactive scene.html orbit "
                         "viewer with frame scrubbing")
    args = ap.parse_args(argv)

    import numpy as np

    if args.show_canonical:
        verts = _load_seq_file(args.data_dir, "vertices_can",
                               args.seq_name, "verts_can")
        # upright canonical pose, posa/vis_dataset.py:73 (sxyz -pi/2 about x)
        from lsdm_tpu_torch.ops.rotations import euler_to_matrix

        R = euler_to_matrix(-np.pi / 2, 0.0, 0.0, "sxyz").numpy().astype(
            np.float32)
        verts = verts @ R.T
    else:
        verts = _load_seq_file(args.data_dir, "vertices",
                               args.seq_name, "verts")
    contacts = _load_seq_file(args.data_dir, "semantics",
                              args.seq_name, "cfs")
    verts = np.asarray(verts, np.float32)
    if verts.ndim == 2:
        verts = verts[None]
    contacts = np.asarray(contacts, np.int32).reshape(len(verts), -1)
    contacts = np.clip(contacts, 0, args.no_obj_classes - 1)

    if args.single_frame >= 0:
        sel = np.asarray([args.single_frame])
    else:
        sel = np.arange(0, len(verts), args.every)[: args.max_frames]
    verts, contacts = verts[sel], contacts[sel]

    scene_v = None
    if args.scene_path and not args.show_canonical:
        from lsdm_tpu_torch.fitting.meshio import load_mesh

        scene_v, _ = load_mesh(args.scene_path)
        scene_v = np.asarray(scene_v, np.float32)

    save_dir = Path(args.save_dir or
                    Path(args.data_dir) / "vis" / args.seq_name)
    save_dir.mkdir(parents=True, exist_ok=True)

    palette = (CONTACT_PALETTE * ((args.no_obj_classes //
                                   len(CONTACT_PALETTE)) + 1))[
        : args.no_obj_classes]

    if not args.no_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        colors = np.asarray(palette)
        for t, (hv, cs) in enumerate(zip(verts, contacts)):
            fig = plt.figure(figsize=(8, 8))
            ax = fig.add_subplot(projection="3d")
            if scene_v is not None and len(scene_v):
                sv = scene_v[:: max(len(scene_v) // 4000, 1)]
                ax.scatter(sv[:, 0], sv[:, 1], sv[:, 2], s=1,
                           c="tab:gray", alpha=0.3)
            ax.scatter(hv[:, 0], hv[:, 1], hv[:, 2], s=2, c=colors[cs])
            ax.set_box_aspect((1, 1, 1))
            ax.view_init(elev=20, azim=45)
            ax.set_title(f"{args.seq_name}  frame {int(sel[t])}")
            fig.savefig(save_dir / f"frame_{int(sel[t]):04d}.png", dpi=80)
            plt.close(fig)

    if args.html:
        from lsdm_tpu_torch.utils.html_viewer import write_scene_html

        objects = []
        if scene_v is not None and len(scene_v):
            objects.append({"verts": scene_v, "color": "#888"})
        write_scene_html(str(save_dir / "scene.html"), frames=verts,
                         objects=objects, frame_labels=contacts,
                         palette=palette)
        print(f"interactive viewer: {save_dir / 'scene.html'}")
    print(f"wrote {len(verts)} frames to {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
