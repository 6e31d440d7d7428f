"""Rotation representation conversions in torch.

Counterpart of ``lsdm_tpu/ops/rotations.py`` (the reference's
``util/rotation_conversions.py``, a pytorch3d-style library, plus the
Euler-angle helpers of ``posa/eulerangles.py``).  Every function is
batched over leading dimensions, with the JAX package's conventions:
quaternions are wxyz, matrices act on column vectors.
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3); q need not be normalised."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0: each of the four
    formulations, and the one of the largest component (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = safe_sqrt(1 + m00 + m11 + m22) / 2
    qx = safe_sqrt(1 + m00 - m11 - m22) / 2
    qy = safe_sqrt(1 - m00 + m11 - m22) / 2
    qz = safe_sqrt(1 - m00 - m11 + m22) / 2
    cands = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1),
    ], -2)  # (..., 4 candidates, 4)
    best = torch.stack([qw, qx, qy, qz], -1).argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q * torch.sign(q[..., :1] + 1e-30)  # canonical w >= 0


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) Rodrigues vector -> (..., 3, 3)."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(angle, min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + torch.sin(a) * K + (1 - torch.cos(a)) * (K @ K)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) Rodrigues vector, through the quaternion."""
    q = matrix_to_quaternion(m)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2 * torch.arccos(w)
    s = torch.sqrt(torch.clamp(1 - w * w, min=1e-12))
    axis = q[..., 1:] / s[..., None]
    small = angle[..., None] < 1e-6
    return torch.where(small, q[..., 1:] * 2, axis * angle[..., None])


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) continuous 6D (Zhou et al.) -> (..., 3, 3) by Gram-Schmidt;
    the rows of the matrix are b1, b2, b3."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    a2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = a2 / torch.clamp(torch.linalg.norm(a2, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], -2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def _about(axis: int, angle: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(angle)
    aa = [zero, zero, zero]
    aa[axis] = angle
    return axis_angle_to_matrix(torch.stack(aa, -1))


def euler_to_matrix(ai, aj, ak, axes: str = "sxyz") -> torch.Tensor:
    """Euler angles -> rotation matrix, static frames ('sxyz': Rz Ry Rx,
    'szyx': Rx Ry Rz), as ``posa/eulerangles.py`` euler2mat."""
    ai, aj, ak = (a if torch.is_tensor(a) else torch.tensor(a, dtype=torch.float32)
                  for a in (ai, aj, ak))
    if axes == "sxyz":
        return _about(2, ak) @ _about(1, aj) @ _about(0, ai)
    if axes == "szyx":
        return _about(0, ak) @ _about(1, aj) @ _about(2, ai)
    raise NotImplementedError(axes)


def rotz(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about z by theta (..., ) -> (..., 3, 3): the fitting
    pipeline's pose parameter."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, zero], -1),
                        torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)
