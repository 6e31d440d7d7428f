"""Write per-frame human meshes for visualization / scene completion
(reference ``gen_human_meshes.py:14-29``).

Counterpart of ``lsdm_tpu/run/gen_human_meshes.py``, with its arguments:
given a (T, V, 3) vertex sequence and template faces, writes
``human/mesh/human_<t>.ply``.  Host-only: numpy and the PLY writer.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the meshes; returns their directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices_path", required=True)
    ap.add_argument("--faces_path", default=None,
                    help="template faces .npy or .obj (e.g. mesh_ds mesh_2)")
    ap.add_argument("--output_dir", required=True)
    args = ap.parse_args(argv)

    import numpy as np

    from lsdm_tpu_torch.fitting.meshio import load_obj, write_ply

    verts = np.load(args.vertices_path).astype(np.float32)
    if verts.ndim == 2:
        verts = verts[None]
    faces = None
    if args.faces_path:
        if args.faces_path.endswith(".obj"):
            _, faces = load_obj(args.faces_path)
        else:
            faces = np.load(args.faces_path).astype(np.int32)

    out = os.path.join(args.output_dir, "human", "mesh")
    os.makedirs(out, exist_ok=True)
    for t, v in enumerate(verts):
        write_ply(os.path.join(out, f"human_{t:04d}.ply"), v, faces)
    print(f"wrote {len(verts)} human meshes to {out}")
    return out


if __name__ == "__main__":
    main()
