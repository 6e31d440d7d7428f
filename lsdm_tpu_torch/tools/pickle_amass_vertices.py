"""AMASS -> per-sequence SMPL-X vertex arrays (reference
``pickle_amass_vertices.py:15-83``): load an AMASS npz, run the SMPL-X body
model, export full-resolution verts plus the 655-vertex downsampled version
(D_1 @ D_2 chain).

Counterpart of ``lsdm_tpu/tools/pickle_amass_vertices.py``, downsampling
with the port's ``ops/mesh.py``.  Offline preprocessing only (the runtime
datasets read the exported .npy, SURVEY.md §2.9).  It needs the external
``smplx`` package and the SMPL-X body-model files, neither of which ships
with the repository: the import is gated, and without it the CLI stops
with the reason.

    python -m lsdm_tpu_torch.tools.pickle_amass_vertices --npz SEQ.npz \\
        --model_folder SMPLX_DIR --out_dir OUT [--mesh_ds_dir data/mesh_ds]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def pickle_amass_vertices(npz_path: str, model_folder: str, mesh_ds_dir: str,
                          out_dir: str, gender: str = "neutral",
                          max_frames: int = 0):
    """Write ``<name>_verts.npy`` (T, 10475, 3) and ``<name>_verts_ds2.npy``
    (T, 655, 3) under ``out_dir``; returns their shapes."""
    try:
        import smplx
    except ImportError as e:
        raise SystemExit(
            "pickle_amass_vertices needs the external 'smplx' package; "
            "install it and download the SMPL-X body models "
            f"(import failed: {e})") from None
    import numpy as np
    import torch

    from lsdm_tpu_torch.ops.mesh import ds_us, get_graph_params

    data = np.load(npz_path)
    poses, trans, betas = data["poses"], data["trans"], data["betas"][:10]
    T = len(poses) if not max_frames else min(max_frames, len(poses))
    body_model = smplx.create(model_path=model_folder, model_type="smplx",
                              gender=gender, batch_size=1, use_pca=False)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    with torch.no_grad():
        verts = torch.stack([body_model(
            betas=f32(betas[None]), global_orient=f32(poses[t:t + 1, :3]),
            body_pose=f32(poses[t:t + 1, 3:66]), transl=f32(trans[t:t + 1]),
            return_verts=True).vertices[0] for t in range(T)])  # (T, 10475, 3)
        # downsample 10475 -> 655 via D_1 then D_2 (reference :60-74)
        g1 = get_graph_params(mesh_ds_dir, 1)
        g2 = get_graph_params(mesh_ds_dir, 2)
        ds = ds_us(g2.D, ds_us(g1.D, verts))

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(npz_path))[0]
    np.save(os.path.join(out_dir, base + "_verts.npy"), verts.numpy().astype(np.float32))
    np.save(os.path.join(out_dir, base + "_verts_ds2.npy"), ds.numpy().astype(np.float32))
    return tuple(verts.shape), tuple(ds.shape)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", required=True, help="AMASS sequence npz")
    ap.add_argument("--model_folder", required=True, help="SMPL-X models dir")
    ap.add_argument("--mesh_ds_dir", default="data/mesh_ds")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--gender", default="neutral")
    ap.add_argument("--max_frames", type=int, default=0)
    a = ap.parse_args(argv)
    full, ds = pickle_amass_vertices(a.npz, a.model_folder, a.mesh_ds_dir,
                                     a.out_dir, a.gender, a.max_frames)
    print(f"wrote {full} full verts and {ds} downsampled verts")
    return full, ds


if __name__ == "__main__":
    main()
