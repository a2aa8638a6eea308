"""Geometric primitives: frames, rotations, dihedrals (torch; port of
decompdiff_tpu/utils/geometry.py).

Role parity with ref utils/geometry.py (construct_3d_basis :84,
dihedral_from_four_points :252, local/global transforms) — mostly unused by
the main training/sampling paths in the reference too, kept for API
completeness and notebook use. Every function computes on its inputs'
device and dtype.
"""

from __future__ import annotations

import torch

from decompdiff_tpu_torch.models.common import safe_norm


def normalize_vector(v, axis=-1, eps=1e-12):
    return v / safe_norm(v, dim=axis, keepdim=True, eps=eps)


def project_v2v(v, e, axis=-1):
    """Project v onto unit vector e (ref utils/geometry.py:70-81)."""
    return (e * v).sum(dim=axis, keepdim=True) * e


def construct_3d_basis(center, p1, p2):
    """Orthonormal frame [e1 e2 e3] from three points (ref :84-109).
    center/p1/p2: [..., 3] -> [..., 3, 3] column basis."""
    e1 = normalize_vector(p1 - center)
    v2 = p2 - center
    e2 = normalize_vector(v2 - project_v2v(v2, e1))
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def local_to_global(R, t, p):
    """q = R p + t; R [..., 3, 3], t [..., 3], p [..., M, 3] (ref :112-131)."""
    return torch.einsum('...ij,...mj->...mi', R, p) + t[..., None, :]


def global_to_local(R, t, q):
    """p = R^T (q - t) (ref :134-153)."""
    return torch.einsum('...ji,...mj->...mi', R, q - t[..., None, :])


def apply_rotation_to_vector(R, p):
    return torch.einsum('...ij,...mj->...mi', R, p)


def dihedral_from_four_points(p0, p1, p2, p3):
    """Signed dihedral angle of p0-p1-p2-p3 (ref :252-268). [..., 3] -> [...]."""
    v0 = p2 - p1
    v1 = p0 - p1
    v2 = p3 - p2
    n1 = normalize_vector(torch.linalg.cross(v0, v1, dim=-1))
    n2 = normalize_vector(torch.linalg.cross(v0, v2, dim=-1))
    sgn = torch.sign((torch.linalg.cross(v1, v2, dim=-1) * v0).sum(-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    cos = (n1 * n2).sum(-1)
    return sgn * torch.arccos(torch.clamp(cos, -1.0, 1.0))


def angle_from_three_points(p0, p1, p2):
    """Angle at p1."""
    v1 = normalize_vector(p0 - p1)
    v2 = normalize_vector(p2 - p1)
    return torch.arccos(torch.clamp((v1 * v2).sum(-1), -1.0, 1.0))


def quaternion_to_rotation_matrix(q):
    """Unit quaternion [..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / safe_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def axis_angle_rotation_matrix(axis, angle):
    """Rodrigues rotation matrix around unit-normalized `axis` [3]."""
    axis = normalize_vector(axis)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    x, y, z = axis[0], axis[1], axis[2]
    s, c = torch.sin(angle), torch.cos(angle)
    t = 1.0 - c
    return torch.stack([
        torch.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y]),
        torch.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x]),
        torch.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c])])


def set_dihedral_on_point_cloud(pos, atom_idx, value, moving_idx=None):
    """Set the (i, j, k, l) dihedral to `value` (radians) by rotating
    `moving_idx` (default: just atom l — pass the full l-side branch when a
    bond graph is available) around the j-k axis. Role parity with ref
    utils/geometry.py:33-58 SetDihedralOnPointCloud, whose body rigidly
    rotates the ENTIRE cloud around j-k — a motion that cannot change any
    internal dihedral; it is uncalled in the reference and implemented
    correctly here instead. Returns a new [N, 3] tensor."""
    pos = torch.as_tensor(pos)
    i, j, k, l = (int(a) for a in atom_idx)
    if moving_idx is None:
        moving_idx = [l]
    moving = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    moving[torch.as_tensor(moving_idx, dtype=torch.long,
                           device=pos.device)] = True
    cur = dihedral_from_four_points(pos[i], pos[j], pos[k], pos[l])
    rot = axis_angle_rotation_matrix(pos[k] - pos[j], value - cur)
    rotated = (pos - pos[k]) @ rot.T + pos[k]
    return torch.where(moving[:, None], rotated, pos)
