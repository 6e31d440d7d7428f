"""Mesh down/up-sampling graph parameters.

Counterpart of ``lsdm_tpu/ops/mesh.py``.  The reference stores sparse
scipy CSR matrices (A/D/U per level) in ``mesh_ds/`` and multiplies them
per sample through a custom sparse-matmul autograd function
(``posa/posa_utils.py:54-94``).  The matrices are small (the largest
655 x 2619), so they are made dense once at load time, as the JAX package
makes them, and :func:`ds_us` is one batched product.
"""

from __future__ import annotations

import os.path as osp
from typing import NamedTuple, Optional

import numpy as np
import torch


class GraphParams(NamedTuple):
    """Dense A (row-normalized adjacency), U (upsample), D (downsample)."""

    A: torch.Tensor
    U: torch.Tensor
    D: torch.Tensor


def row_normalized_adjacency(adj: "np.ndarray | object", nsize: int = 1) -> np.ndarray:
    """Row-normalized adjacency with self-loops
    (reference ``adjmat_sparse``, ``posa_utils.py:32-51``)."""
    import scipy.sparse as sp

    adjmat = sp.csr_matrix(adj)
    if nsize > 1:
        orig = adjmat.copy()
        for _ in range(1, nsize):
            adjmat = adjmat * orig
    adjmat.data = np.ones_like(adjmat.data)
    adjmat = sp.lil_matrix(adjmat)
    for i in range(adjmat.shape[0]):
        adjmat[i, i] = 1
    adjmat = sp.csr_matrix(adjmat)
    num_neighbors = np.asarray(1.0 / adjmat.sum(axis=-1)).ravel()
    adjmat = sp.diags(num_neighbors) @ adjmat
    return np.asarray(adjmat.todense(), np.float32)


def _graph(A: np.ndarray, U: np.ndarray, D: np.ndarray,
           device: Optional[torch.device]) -> GraphParams:
    return GraphParams(*(torch.as_tensor(np.asarray(m, np.float32), device=device)
                         for m in (A, U, D)))


def get_graph_params(ds_us_dir: str, layer: int = 1,
                     device: Optional[torch.device] = None) -> GraphParams:
    """Load A/D/U npz for a level and densify onto ``device``
    (reference ``get_graph_params``, ``posa_utils.py:105-116``)."""
    import scipy.sparse as sp

    A = sp.load_npz(osp.join(ds_us_dir, f"A_{layer}.npz"))
    D = sp.load_npz(osp.join(ds_us_dir, f"D_{layer}.npz"))
    U = sp.load_npz(osp.join(ds_us_dir, f"U_{layer}.npz"))
    return _graph(row_normalized_adjacency(A), U.todense(), D.todense(), device)


def ds_us(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mesh down/up-sample: batched dense matmul ``M @ x``.

    x: (..., N, C); M: (N', N) -> (..., N', C), in at least float32 (the
    JAX function's ``preferred_element_type``).  Replaces the reference's
    per-sample sparse loop (``posa_utils.py:78-94``) with one product.
    """
    dtype = torch.promote_types(torch.promote_types(M.dtype, x.dtype),
                                torch.float32)
    return torch.matmul(M.to(dtype), x.to(dtype))


def synthetic_graph_params(nv_out: int, nv_in: int,
                           device: Optional[torch.device] = None) -> GraphParams:
    """Deterministic fake D/U/A for tests when mesh_ds data is absent:
    D averages pairs of consecutive vertices; U repeats."""
    D = np.zeros((nv_out, nv_in), np.float32)
    for i in range(nv_out):
        src = min(2 * i, nv_in - 1)
        D[i, src] = 0.5
        D[i, min(src + 1, nv_in - 1)] += 0.5
    U = np.zeros((nv_in, nv_out), np.float32)
    for i in range(nv_in):
        U[i, min(i // 2, nv_out - 1)] = 1.0
    return _graph(np.eye(nv_out, dtype=np.float32), U, D, device)
