"""Spiral-sequence extraction from triangle meshes, in numpy.

A copy of ``lsdm_tpu/ops/spiral.py`` (``identity_spirals``, ``load_obj``,
``_ordered_one_rings``, ``extract_spirals``, ``grid_mesh``; importing the
JAX package's ``ops`` imports jax).  It replaces the reference's
openmesh one-ring walk (``posa/posa_utils.py:119-177``) with a half-edge
traversal built from the face array.  Spirals are static per mesh level:
extract them once and hand the (N, L) index array to
:class:`~lsdm_tpu_torch.models.posa.SpiralConv`.

Where the ring expansion runs dry, the JAX function takes the vertex's
nearest neighbours from scikit-learn's ``KDTree``, which the GPU machine
does not have.  :func:`_kdtree_knn` reproduces that query: it pushes every
vertex in index order into the query's fixed-size max-heap and sorts the
result by insertion, so ties come out in sklearn's order on a tree of at
most 80 vertices (one leaf at the default ``leaf_size`` 40) and for at
most 15 neighbours (sklearn sorts longer rows by introsort).  Beyond
those sizes sklearn may order ties apart; the neighbours and their
distances are the same.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def identity_spirals(num_vertices: int) -> np.ndarray:
    """Length-1 spirals: each vertex attends to itself (SDM human backbone)."""
    return np.arange(num_vertices, dtype=np.int32)[:, None]


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ loader (v / f lines only) — replaces trimesh for the
    template meshes in ``mesh_ds/mesh_{0..5}.obj``."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int32)


def _ordered_one_rings(faces: np.ndarray, nv: int) -> List[List[int]]:
    """Ordered one-ring neighbourhoods via half-edge walking.

    For each vertex, neighbours are returned in consistent winding order
    (starting from an arbitrary neighbour; boundary vertices start from a
    boundary edge so the ring is a contiguous fan).
    """
    # next-vertex map per directed edge within a face: (a->b) exists if some
    # face is (a, b, c); opposite(a->b) = (b->a).
    succ: Dict[Tuple[int, int], int] = {}
    out_edges: List[List[int]] = [[] for _ in range(nv)]
    for (a, b, c) in faces:
        succ[(a, b)] = c
        succ[(b, c)] = a
        succ[(c, a)] = b
        out_edges[a].append(b)
        out_edges[b].append(c)
        out_edges[c].append(a)

    rings: List[List[int]] = []
    for v in range(nv):
        nbrs = out_edges[v]
        if not nbrs:
            rings.append([])
            continue
        # a boundary start: a neighbour n with no edge (n, v), so the walk
        # cannot step backwards from n around v
        start = next((n for n in nbrs if (n, v) not in succ), nbrs[0])
        ring = [start]
        seen = {start}
        cur = start
        while True:
            # rotate around v: the vertex after `cur` in the ring is
            # succ[(v, cur)] (third vertex of face (v, cur, .)).
            nxt = succ.get((v, cur))
            if nxt is None or nxt in seen:
                break
            ring.append(nxt)
            seen.add(nxt)
            cur = nxt
        # pick up any neighbours missed by a broken fan (non-manifold)
        for n in nbrs:
            if n not in seen:
                ring.append(n)
                seen.add(n)
        rings.append(ring)
    return rings


def _kdtree_knn(verts: np.ndarray, v: int, k: int) -> List[int]:
    """The ``k`` nearest vertices of vertex ``v``, nearest first, as
    ``sklearn.neighbors.KDTree(verts).query(verts[v:v+1], k)`` orders
    them (exactly so on at most 80 vertices; module docstring)."""
    d = verts - verts[v]
    rdist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    vals = [np.inf] * k
    idx = [0] * k
    for i, val in enumerate(rdist.tolist()):  # sklearn's heap_push
        if val >= vals[0]:
            continue
        cur = 0
        while True:
            left, right = 2 * cur + 1, 2 * cur + 2
            if left >= k:
                break
            if right >= k:
                if vals[left] <= val:
                    break
                swap = left
            elif vals[left] >= vals[right]:
                if val >= vals[left]:
                    break
                swap = left
            else:
                if val >= vals[right]:
                    break
                swap = right
            vals[cur], idx[cur] = vals[swap], idx[swap]
            cur = swap
        vals[cur], idx[cur] = val, i
    order = sorted(range(k), key=lambda j: vals[j])  # stable, as insertion
    return [idx[j] for j in order]


def extract_spirals(
    verts: np.ndarray,
    faces: np.ndarray,
    seq_length: int,
    dilation: int = 1,
) -> np.ndarray:
    """Spiral index sequences (N, seq_length).

    Same ring-expansion algorithm as reference ``extract_spirals``
    (``posa_utils.py:142-170``): start at the vertex, append whole rings
    until the spiral is long enough; if the mesh runs out of rings, fall
    back to euclidean nearest neighbours.
    """
    nv = verts.shape[0]
    if seq_length == 1:
        return identity_spirals(nv)
    rings = _ordered_one_rings(faces, nv)
    want = seq_length * dilation
    spirals = []
    for v in range(nv):
        spiral = [v]
        spiral_set = {v}
        last_ring = list(rings[v])
        while last_ring and len(spiral) < want:
            spiral.extend(last_ring)
            spiral_set.update(last_ring)
            nxt: List[int] = []
            nxt_set = set()
            for u in last_ring:
                for w in rings[u]:
                    if w not in spiral_set and w not in nxt_set:
                        nxt.append(w)
                        nxt_set.add(w)
            last_ring = nxt
        if len(spiral) < want:
            spiral = _kdtree_knn(np.asarray(verts, np.float64), v, min(want, nv))
            while len(spiral) < want:  # mesh smaller than window
                spiral.append(spiral[-1])
        spirals.append(spiral[:want:dilation])
    return np.asarray(spirals, np.int32)


def grid_mesh(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic n x n triangulated grid — test/fallback mesh when the
    reference's ``mesh_ds`` template meshes are not on disk."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    verts = np.stack(
        [ii.ravel() / max(n - 1, 1), jj.ravel() / max(n - 1, 1), np.zeros(n * n)], 1
    )
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts, np.asarray(faces, np.int32)
