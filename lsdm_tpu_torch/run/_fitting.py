"""What the fitting CLIs share: the human surface."""

from __future__ import annotations

import numpy as np


def human_surface(verts_seq: np.ndarray, faces) -> np.ndarray:
    """Points of the human sequence's surface: 4096 samples a frame when
    faces are given, else the vertices (JAX ``run/fit_*_obj.py``)."""
    from lsdm_tpu_torch.fitting.meshio import sample_surface

    if faces is None:
        return verts_seq.reshape(-1, 3)
    return np.concatenate([sample_surface(v, faces, 4096, seed=i)
                           for i, v in enumerate(verts_seq)])
