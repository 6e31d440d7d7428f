"""Fit CAD meshes driven by predicted contact labels
(reference ``fit_best_obj.py``).

Counterpart of ``lsdm_tpu/run/fit_best_obj.py``, with its arguments:
voxel-downsample + majority-vote the contact-labelled human vertices into
per-class clusters, then run the same fitting as ``fit_custom_obj`` on
``--device`` (cuda by default; without a GPU it refuses unless
``--device cpu`` is given; the JAX flag ``--platform`` is refused).

Usage:
  python -m lsdm_tpu_torch.run.fit_best_obj --vertices_path X_verts.npy \\
      --contact_labels X_labels.npy --obj_lib data/obj_library \\
      --output_dir fitting_results
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from lsdm_tpu_torch.run import _fitting, jax_flags


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the fitting; returns ``fit_contact_clusters``' results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices_path", required=True)
    ap.add_argument("--contact_labels", required=True,
                    help="(T, V) int contact predictions .npy")
    ap.add_argument("--faces_path", default=None)
    ap.add_argument("--obj_lib", required=True)
    ap.add_argument("--output_dir", default="fitting_results")
    ap.add_argument("--sdf_dim", type=int, default=256)
    ap.add_argument("--down_sample", type=int, default=8)
    jax_flags.add_device(ap)
    args = ap.parse_args(argv)
    dev = jax_flags.device(args, "fit_best_obj")

    import numpy as np

    from lsdm_tpu_torch.fitting.fit_objects import (
        cluster_contact_points, fit_contact_clusters, vote_contact_points)
    from lsdm_tpu_torch.fitting.meshio import read_human_mesh_sequence
    from lsdm_tpu_torch.fitting.sdf import cached_sdf
    from lsdm_tpu_torch.ops.geometry import estimate_floor_height

    verts_seq, faces = read_human_mesh_sequence(
        args.vertices_path, args.faces_path, args.down_sample)
    labels = np.load(args.contact_labels).astype(np.int32)[:: args.down_sample]
    if labels.ndim == 3:
        labels = labels.argmax(-1)

    surface = _fitting.human_surface(verts_seq, faces)
    os.makedirs(args.output_dir, exist_ok=True)
    sdf, centroid, extents = cached_sdf(
        os.path.join(args.output_dir, "human_sdf.npz"), surface, args.sdf_dim)
    floor = estimate_floor_height(surface)

    voted = vote_contact_points(verts_seq, labels)
    clusters_by_class = {
        cid: cluster_contact_points(pts, cid) for cid, pts in voted.items()}
    clusters_by_class = {k: v for k, v in clusters_by_class.items() if v}
    print({k: len(v) for k, v in clusters_by_class.items()})

    results = fit_contact_clusters(
        clusters_by_class, args.obj_lib, sdf, centroid, extents, floor,
        os.path.join(args.output_dir, "fit_best_obj"), device=dev)
    for r in results:
        print(f"{r['class']}/{r['cluster']}: best={r['obj_id']} loss={r['loss']:.4f}")
    return results


if __name__ == "__main__":
    main()
