"""Fit CAD meshes to LSDM-generated points (reference ``fit_custom_obj.py``).

Counterpart of ``lsdm_tpu/run/fit_custom_obj.py``, with its arguments.
Takes the ``predictions/<seq>.npy`` cloud written by ``test_sdm`` as the
contact cluster directly (no voting — the diff vs ``fit_best_obj``), builds
the human SDF, clusters, and runs the grid search + Adam fitting on
``--device`` (cuda by default; without a GPU it refuses unless
``--device cpu`` is given; the JAX flag ``--platform`` is refused).

Usage:
  python -m lsdm_tpu_torch.run.fit_custom_obj --file_name out/predictions/X.npy \\
      --label table --vertices_path data/.../X_verts.npy \\
      --obj_lib data/obj_library --output_dir fitting_results [--sdf_dim 128]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from lsdm_tpu_torch.run import _fitting, jax_flags


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the fitting; returns ``fit_contact_clusters``' results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--file_name", required=True, help="predictions .npy")
    ap.add_argument("--label", required=True, help="object class name, e.g. table")
    ap.add_argument("--vertices_path", required=True,
                    help="(T, V, 3) human vertex sequence .npy")
    ap.add_argument("--faces_path", default=None)
    ap.add_argument("--obj_lib", required=True, help="candidate .obj directory")
    ap.add_argument("--output_dir", default="fitting_results")
    ap.add_argument("--sdf_dim", type=int, default=256)
    ap.add_argument("--down_sample", type=int, default=8)
    ap.add_argument("--floor_height", type=float, default=None)
    jax_flags.add_device(ap)
    args = ap.parse_args(argv)
    dev = jax_flags.device(args, "fit_custom_obj")

    import numpy as np

    from lsdm_tpu_torch.fitting.fit_objects import (
        cluster_contact_points, fit_contact_clusters)
    from lsdm_tpu_torch.fitting.meshio import (
        MPCAT40_CLASS_IDS, read_human_mesh_sequence)
    from lsdm_tpu_torch.fitting.sdf import cached_sdf
    from lsdm_tpu_torch.ops.geometry import estimate_floor_height

    pred = np.load(args.file_name).astype(np.float32).reshape(-1, 3)
    class_id = MPCAT40_CLASS_IDS.get(args.label, 5)

    verts_seq, faces = read_human_mesh_sequence(
        args.vertices_path, args.faces_path, args.down_sample)
    surface = _fitting.human_surface(verts_seq, faces)

    os.makedirs(args.output_dir, exist_ok=True)
    sdf, centroid, extents = cached_sdf(
        os.path.join(args.output_dir, "human_sdf.npz"), surface, args.sdf_dim)
    floor = (args.floor_height if args.floor_height is not None
             else estimate_floor_height(surface))
    print(f"floor height: {floor:.3f}; sdf grid {args.sdf_dim}^3")

    clusters = cluster_contact_points(pred, class_id)
    if not clusters:
        clusters = [pred]  # whole prediction as one cluster
    print(f"{len(clusters)} contact cluster(s) for class {args.label}")

    results = fit_contact_clusters(
        {class_id: clusters}, args.obj_lib, sdf, centroid, extents, floor,
        os.path.join(args.output_dir, "fit_best_obj"), device=dev)
    for r in results:
        print(f"cluster {r['cluster']}: best={r['obj_id']} loss={r['loss']:.4f}")
    return results


if __name__ == "__main__":
    main()
