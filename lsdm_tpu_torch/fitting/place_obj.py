"""Pose optimization for object placement (reference ``place_obj_opt.py``).

Counterpart of ``lsdm_tpu/fitting/place_obj.py`` on torch tensors on the
caller's device:

  * :func:`grid_search` scores all 36 rotations x 11 x 11 translations
    (4356 poses) in batched tensor ops, in chunks of poses so that the
    (poses, contact points, object points) distances fit in memory, and
    takes the first minimum, as ``jnp.argmin`` does.  Every chunk has the
    same number of poses (the last is padded with copies of the last
    pose), so each chunk runs the same products and the chunking changes
    no loss;
  * :func:`refine_pose` runs the 200-step Adam refinement (torch
    ``Adam(weight_decay=1e-4)``: L2 added to the gradient before the
    moments, as the JAX chain ``add_decayed_weights(1e-4) ->
    scale_by_adam() -> scale(-lr)`` does) and keeps the best-so-far pose
    on the device with ``torch.where``, so its steps never wait for the
    host.

The losses are the reference's (contact: weight x mean over contact points
of the squared distance to the nearest object point,
``place_obj_opt.py:10-15``; penetration: weight x sum of the squared
signed distances below a threshold, ``:32-47``), in float32 without TF32
(the JAX package uses ``Precision.HIGHEST``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from lsdm_tpu_torch.ops.geometry import trilinear
from lsdm_tpu_torch.ops.rotations import rotz

# bytes of (poses, contact, object) distances a grid-search chunk may hold
GRID_CHUNK_BYTES = 1 << 30
_DEG2RAD = np.float32(np.pi / 180)  # jnp.deg2rad's float32 constant


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for the block (``Precision.HIGHEST``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _device(device, *arrays) -> torch.device:
    """``device``, else that of the first tensor among ``arrays``, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _sq_dists(contact_points: torch.Tensor, object_points: torch.Tensor
              ) -> torch.Tensor:
    """|c|^2 + |o|^2 - 2 c.o, (C, 3) x (..., N, 3) -> (..., C, N), in the
    JAX function's order."""
    cc = (contact_points ** 2).sum(-1)
    oo = (object_points ** 2).sum(-1)
    s = cc[:, None] + oo[..., None, :]
    with _full_fp32():
        if object_points.dim() == 2:
            return torch.addmm(s, contact_points, object_points.t(), alpha=-2.0)
        c = contact_points.expand(object_points.shape[0], -1, -1)
        return torch.baddbmm(s, c, object_points.transpose(1, 2), alpha=-2.0)


def contact_loss(contact_points: torch.Tensor, object_points: torch.Tensor,
                 weight: float = 100.0) -> torch.Tensor:
    """weight x mean over contact points (C, 3) of the squared distance to
    the nearest object point (..., N, 3) -> (...) (reference
    ``place_obj_opt.py:10-15``).  The clamp at 0 and the minimum share a
    tie's gradient evenly, as JAX's ``maximum`` and ``min`` do."""
    d2 = _sq_dists(contact_points, object_points)
    mins = torch.maximum(d2, torch.zeros((), dtype=d2.dtype, device=d2.device))
    return weight * mins.amin(dim=-1).sum(-1) / contact_points.shape[0]


def compute_signed_distances(sdf: torch.Tensor, sdf_centroid: torch.Tensor,
                             sdf_extents: torch.Tensor,
                             query_points: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF lookup (..., 3) -> (...) with the fitting pipeline's
    normalization (reference ``place_obj_opt.py:18-29``): points normalized
    by ``(q - centroid) * 2 / extents.max()`` into [-1, 1], mapped onto the
    grid (align_corners), clipped to [0, D - 1] and sampled as
    ``map_coordinates(order=1, mode="nearest")``."""
    D = sdf.shape[0]
    norm = (query_points - sdf_centroid) * 2.0 / sdf_extents.max()
    coords = torch.clamp((norm + 1.0) / 2.0 * (D - 1), 0, D - 1)
    return trilinear(coords, sdf)


def penetration_loss(sdf: torch.Tensor, sdf_centroid: torch.Tensor,
                     sdf_extents: torch.Tensor, object_points: torch.Tensor,
                     pen_thresh: float = 0.0, weight: float = 10.0
                     ) -> torch.Tensor:
    """weight x sum of the squared signed distances below the threshold,
    object points (..., N, 3) -> (...) (reference ``place_obj_opt.py:
    32-47``)."""
    sd = compute_signed_distances(sdf, sdf_centroid, sdf_extents, object_points)
    return weight * torch.where(sd < pen_thresh, sd ** 2, 0.0).sum(-1)


def _place(points: torch.Tensor, deg_or_rad: torch.Tensor, dx: torch.Tensor,
           dy: torch.Tensor) -> torch.Tensor:
    """points (N, 3) rotated about z by the angles (P,) (radians), then
    shifted by (dx, dy) (P,) in x and y -> (P, N, 3)."""
    with _full_fp32():
        pts = torch.matmul(points, rotz(deg_or_rad).transpose(-1, -2))
    shift = torch.stack([dx, dy, torch.zeros_like(dx)], -1)  # (P, 3)
    return pts + shift[:, None, :]


class GridResult(NamedTuple):
    loss: torch.Tensor
    rot_deg: torch.Tensor
    transl_x: torch.Tensor
    transl_y: torch.Tensor
    points: torch.Tensor


def grid_poses(obj_points_centered: torch.Tensor, contact_points: torch.Tensor
               ) -> torch.Tensor:
    """The (4356, 3) poses (degrees, x, y), rotation-major: 36 rotations
    10 degrees apart, and 11 x 11 translations sliding the object's bbox
    across the contact cluster's (reference ``place_obj_opt.py:70-73``)."""
    dev = obj_points_centered.device
    obj_min, obj_max = obj_points_centered.amin(0), obj_points_centered.amax(0)
    c_min, c_max = contact_points.amin(0), contact_points.amax(0)
    min_x, max_x = c_min[0] - obj_max[0], c_max[0] - obj_min[0]
    min_y, max_y = c_min[1] - obj_max[1], c_max[1] - obj_min[1]
    steps = torch.arange(11, dtype=torch.float32, device=dev)
    xs = min_x + (max_x - min_x) / 10.0 * steps
    ys = min_y + (max_y - min_y) / 10.0 * steps
    degs = torch.arange(0, 360, 10, dtype=torch.float32, device=dev)
    R, X, Y = torch.meshgrid(degs, xs, ys, indexing="ij")
    return torch.stack([R.reshape(-1), X.reshape(-1), Y.reshape(-1)], -1)


def grid_search(obj_points_centered, obj_center_xy, contact_points, sdf,
                sdf_centroid, sdf_extents, contact_weight: float = 100.0,
                pen_thresh: float = -0.05, pen_weight: float = 10.0,
                device=None, chunk: Optional[int] = None) -> GridResult:
    """Exhaustive pose grid (JAX ``grid_search``).  Arrays or tensors;
    computes on ``device`` (default: that of the first tensor given, else
    the CPU).  ``chunk``: poses a chunk (default: as many as
    ``GRID_CHUNK_BYTES`` of distances hold).  Returns 0-d tensors and the
    best pose's points (N, 3), on that device."""
    dev = _device(device, sdf, obj_points_centered, contact_points)
    obj = _tensor(obj_points_centered, dev)
    center = _tensor(obj_center_xy, dev)
    contact = _tensor(contact_points, dev)
    sdf, centroid, extents = (_tensor(a, dev) for a in (sdf, sdf_centroid, sdf_extents))
    poses = grid_poses(obj, contact)
    P = poses.shape[0]
    if chunk is None:
        chunk = max(1, GRID_CHUNK_BYTES // (4 * contact.shape[0] * obj.shape[0]))
    chunk = min(chunk, P)
    n_chunks = -(-P // chunk)
    padded = torch.cat([poses, poses[-1:].expand(n_chunks * chunk - P, 3)])
    losses = []
    with torch.no_grad():
        for i in range(n_chunks):
            p = padded[i * chunk:(i + 1) * chunk]
            pts = _place(obj, p[:, 0] * _DEG2RAD, center[0] + p[:, 1],
                         center[1] + p[:, 2])
            losses.append(contact_loss(contact, pts, contact_weight)
                          + penetration_loss(sdf, centroid, extents, pts,
                                             pen_thresh, pen_weight))
    losses = torch.cat(losses)[:P]
    best = torch.argmin(losses)  # the first minimum
    pose = poses[best]
    pts = _place(obj, pose[None, 0] * _DEG2RAD, center[0] + pose[None, 1],
                 center[1] + pose[None, 2])[0]
    return GridResult(loss=losses[best], rot_deg=pose[0], transl_x=pose[1],
                      transl_y=pose[2], points=pts)


class RefineResult(NamedTuple):
    loss: torch.Tensor
    rot: torch.Tensor
    transl_x: torch.Tensor
    transl_y: torch.Tensor
    points: torch.Tensor


def refine_pose(obj_points_centered, grid_center_xy, grid_rot_deg: float,
                contact_points, sdf, sdf_centroid, sdf_extents,
                contact_weight: float = 100.0, pen_thresh: float = 0.0,
                pen_weight: float = 1.0, lr: float = 0.003,
                opt_steps: int = 200, device=None) -> RefineResult:
    """Adam refinement of (theta, tx, ty) from the grid-search pose
    (reference ``optimization``, ``place_obj_opt.py:102-170``; JAX
    ``refine_pose``), on ``device`` as :func:`grid_search` chooses it.
    The identity-pose candidate (reference :119-135) starts the best."""
    dev = _device(device, sdf, obj_points_centered, contact_points)
    contact = _tensor(contact_points, dev)
    center = _tensor(grid_center_xy, dev)
    sdf, centroid, extents = (_tensor(a, dev) for a in (sdf, sdf_centroid, sdf_extents))
    rot0 = torch.full((), grid_rot_deg, dtype=torch.float32, device=dev) * _DEG2RAD
    with _full_fp32():
        start = _tensor(obj_points_centered, dev) @ rotz(rot0).t()

    def loss_fn(rot, x, y):
        pts = _place(start, rot, center[0] + x, center[1] + y)[0]
        return (contact_loss(contact, pts, contact_weight)
                + penetration_loss(sdf, centroid, extents, pts, pen_thresh,
                                   pen_weight)), pts

    zero = torch.zeros((), device=dev)
    with torch.no_grad():
        loss, pts = loss_fn(zero[None], zero[None], zero[None])
    best = [loss, zero, zero, zero, pts]
    rot = torch.full((1,), 0.01, device=dev, requires_grad=True)
    x = torch.full((1,), 0.001, device=dev, requires_grad=True)
    y = torch.full((1,), 0.001, device=dev, requires_grad=True)
    opt = torch.optim.Adam([rot, x, y], lr=lr, weight_decay=1e-4)
    for _ in range(opt_steps):
        opt.zero_grad()
        loss, pts = loss_fn(rot, x, y)
        with torch.no_grad():
            better = loss < best[0]
            best = [torch.where(better, new, old) for new, old in
                    zip((loss, rot[0], x[0], y[0], pts), best)]
        loss.backward()
        opt.step()
    return RefineResult(*(t.detach() for t in best))
