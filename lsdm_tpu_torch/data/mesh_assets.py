"""mesh_ds asset loading: template meshes, spirals, down/up matrices.

Counterpart of ``lsdm_tpu/data/mesh_assets.py``.  The reference ships
precomputed sparse matrices and template meshes in ``mesh_ds/`` and
extracts spirals with openmesh at model-construction time
(``posa/posa_models.py:227-244``).  Here spirals are extracted once with
the numpy half-edge walker and cached to ``spirals_<level>_<len>.npy``
next to the meshes; when no mesh_ds directory exists (the repository
ships none: it arrives with the dataset download, reference
``README.md:35-48``), deterministic synthetic grid assets keep everything
runnable, flagged ``synthetic``, as the JAX package builds them.  The
down/up matrices land on the caller's ``device``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lsdm_tpu_torch.ops.mesh import get_graph_params, synthetic_graph_params
from lsdm_tpu_torch.ops.spiral import extract_spirals, grid_mesh, load_obj

BODY_NV = (655, 164, 41)  # reference mesh levels 2/3/4 (posa_models.py:261)


class MeshAssets(NamedTuple):
    nv: Tuple[int, ...]
    spiral_indices: Tuple[np.ndarray, ...]  # per level (nv_l, seq_length)
    down_mats: Tuple[torch.Tensor, ...]  # D_1 (164, 655), D_2 (41, 164)
    up_mats: Tuple[torch.Tensor, ...]
    synthetic: bool


def load_mesh_assets(
    mesh_ds_dir: str = "data/mesh_ds",
    seq_length: int = 9,
    nv_override: Sequence[int] | None = None,
    device: Optional[torch.device] = None,
) -> MeshAssets:
    if os.path.isdir(mesh_ds_dir) and os.path.exists(
        os.path.join(mesh_ds_dir, "mesh_2.obj")
    ):
        spirals: List[np.ndarray] = []
        nv: List[int] = []
        for level in (0, 1, 2):  # mesh levels 2/3/4 (load_ds_us_param level+2)
            mesh_path = os.path.join(mesh_ds_dir, f"mesh_{level + 2}.obj")
            cache = os.path.join(
                mesh_ds_dir, f"spirals_{level + 2}_{seq_length}.npy"
            )
            if os.path.exists(cache):
                sp = np.load(cache)
            else:
                verts, faces = load_obj(mesh_path)
                sp = extract_spirals(verts, faces, seq_length)
                try:
                    np.save(cache, sp)
                except OSError:
                    pass
            spirals.append(sp.astype(np.int32))
            nv.append(sp.shape[0])
        g1 = get_graph_params(mesh_ds_dir, 3, device)  # D_3: level2 -> level3
        g2 = get_graph_params(mesh_ds_dir, 4, device)
        return MeshAssets(
            nv=tuple(nv),
            spiral_indices=tuple(spirals),
            down_mats=(g1.D, g2.D),
            up_mats=(g1.U, g2.U),
            synthetic=False,
        )

    # synthetic fallback: grid meshes with matching vertex counts
    nv = tuple(nv_override) if nv_override else BODY_NV
    spirals = []
    for n in nv:
        side = int(np.ceil(np.sqrt(n)))
        verts, faces = grid_mesh(side)
        sp = extract_spirals(verts, faces, seq_length)[:n]
        sp = np.clip(sp, 0, n - 1)
        spirals.append(sp.astype(np.int32))
    d1 = synthetic_graph_params(nv[1], nv[0], device)
    d2 = synthetic_graph_params(nv[2], nv[1], device)
    return MeshAssets(
        nv=nv,
        spiral_indices=tuple(spirals),
        down_mats=(d1.D, d2.D),
        up_mats=(d1.U, d2.U),
        synthetic=True,
    )
