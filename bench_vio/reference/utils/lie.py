# Frozen copy of msckf_stereo_c_torch/utils/lie.py at commit 50013dad8c92.
"""SO(3) primitives on tensors, batched over leading dims (port of
``msckf_stereo_c_tpu/utils/lie.py``; only what the main path uses)."""
from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x such that [v]x w = v x w. Batched."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with series fallbacks near zero (batched)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < 1e-16
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_t = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_sq)
    K = skew(phi)
    return _eye(3, phi) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (principal branch, batched):
    theta = atan2(|w|/2, (tr-1)/2) with w the skew part, a series near the
    identity; angles near pi are outside its use."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    nsq = torch.sum(w * w, dim=-1)  # = 4 sin^2(theta)
    small = nsq < 1e-24
    s = 0.5 * torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    theta = torch.atan2(s, 0.5 * (tr - 1.0))
    scale = torch.where(
        small, 0.5 + nsq / 48.0, theta / torch.where(small, torch.ones_like(s), 2.0 * s)
    )
    return w * scale[..., None]


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Angle of the rotation (AngleAxis().angle() equivalent), batched."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))


def rot_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R with R @ normalize(a) = normalize(b)."""
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    v = torch.linalg.cross(an, bn, dim=-1)
    c = torch.sum(an * bn, dim=-1)
    K = skew(v)
    denom = 1.0 + c
    safe = torch.abs(denom) > 1e-12
    factor = torch.where(
        safe, 1.0 / torch.where(safe, denom, torch.ones_like(denom)), torch.zeros_like(denom)
    )
    return _eye(3, a) + K + (K @ K) * factor[..., None, None]


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    """Inverse of the transform x -> R x + t, as (R^T, -R^T t). Batched."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """Compose transforms: (Ra,ta) applied after (Rb,tb):
    x -> Ra (Rb x + tb) + ta. Batched."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta
