# Frozen copy of msckf_stereo_c_torch/utils/quaternion.py at commit 50013dad8c92.
"""JPL-convention quaternions ``[x, y, z, w]`` (world -> body), batched over
leading dims (port of ``msckf_stereo_c_tpu/utils/quaternion.py``)."""
from __future__ import annotations

import torch

from .lie import skew


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_identity(dtype=torch.float64, device=None) -> torch.Tensor:
    q = torch.zeros(4, dtype=dtype, device=device)
    q[3] = 1.0
    return q


def jpl_to_rot(q: torch.Tensor) -> torch.Tensor:
    """C(q) = (2w^2-1) I - 2w [qv]x + 2 qv qv^T (Trawny eq. 90)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    outer = qv[..., :, None] * qv[..., None, :]
    return (
        (2.0 * w[..., None] * w[..., None, :] - 1.0) * eye
        - 2.0 * w[..., None] * skew(qv)
        + 2.0 * outer
    )


def rot_to_jpl(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (world->body) -> JPL quaternion, branch-free
    Shepperd-style selection of the best-conditioned candidate."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    m = torch.stack(
        [
            1.0 + 2.0 * R[..., 0, 0] - t,
            1.0 + 2.0 * R[..., 1, 1] - t,
            1.0 + 2.0 * R[..., 2, 2] - t,
            1.0 + t,
        ],
        dim=-1,
    )
    m = torch.clamp(m, min=0.0)
    idx = torch.argmax(m, dim=-1, keepdim=True)
    s = torch.sqrt(torch.gather(m, -1, idx))[..., 0]
    inv = 1.0 / torch.where(s == 0, torch.ones_like(s), s)

    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    d01 = R[..., 0, 1] - R[..., 1, 0]
    d20 = R[..., 2, 0] - R[..., 0, 2]
    d12 = R[..., 1, 2] - R[..., 2, 1]

    q_from_x = torch.stack([0.5 * s, 0.5 * s01 * inv, 0.5 * s02 * inv, 0.5 * d12 * inv], dim=-1)
    q_from_y = torch.stack([0.5 * s01 * inv, 0.5 * s, 0.5 * s12 * inv, 0.5 * d20 * inv], dim=-1)
    q_from_z = torch.stack([0.5 * s02 * inv, 0.5 * s12 * inv, 0.5 * s, 0.5 * d01 * inv], dim=-1)
    q_from_w = torch.stack([0.5 * d12 * inv, 0.5 * d20 * inv, 0.5 * d01 * inv, 0.5 * s], dim=-1)

    cand = torch.stack([q_from_x, q_from_y, q_from_z, q_from_w], dim=-2)
    q = torch.gather(cand, -2, idx[..., None].expand(*idx.shape[:-1], 1, 4))[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return quat_normalize(q)


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """JPL product q (x) p with C(q (x) p) = C(q) C(p) (Trawny eq. 6)."""
    qv, qw = q[..., :3], q[..., 3:4]
    pv, pw = p[..., :3], p[..., 3:4]
    qv, pv = torch.broadcast_tensors(qv, pv)
    v = qw * pv + pw * qv - torch.linalg.cross(qv, pv, dim=-1)
    w = qw * pw - torch.sum(qv * pv, dim=-1, keepdim=True)
    return quat_normalize(torch.cat([v, w], dim=-1))


def small_angle_quaternion(dtheta: torch.Tensor) -> torch.Tensor:
    """JPL quaternion of a small error angle (reference
    ``Quarternion::small_angle_quaternion``)."""
    dq = 0.5 * dtheta
    nsq = torch.sum(dq * dq, dim=-1, keepdim=True)
    small = nsq < 1.0
    w_small = torch.sqrt(torch.clamp(1.0 - nsq, min=0.0))
    scale_big = 1.0 / torch.sqrt(1.0 + nsq)
    v = torch.where(small, dq, dq * scale_big)
    w = torch.where(small, w_small, scale_big)
    return torch.cat([v, w], dim=-1)


def jpl_to_hamilton(q: torch.Tensor) -> torch.Tensor:
    """A JPL world->body quaternion as the Hamilton body->world quaternion
    [x, y, z, w] of trajectory export (TUM): C_jpl(q) = R_w_b is the
    Hamilton rotation of the conjugate, and R_b_w = R_w_b^T undoes the
    conjugation, so the components are unchanged."""
    return q


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by C(q): world->body application."""
    return (jpl_to_rot(q) @ v[..., None])[..., 0]
