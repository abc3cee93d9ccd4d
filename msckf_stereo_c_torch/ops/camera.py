"""Camera distortion models, radtan + equidistant (port of
``msckf_stereo_c_tpu/ops/camera.py``).  Points are (..., 2) tensors and
intrinsics (4,) [fx, fy, cx, cy].

On a CUDA tensor ``undistort_points`` is one launch of the hand-written
kernel ``undistort_points`` (``csrc/undistort_points.cu``): the normalizing,
the 20 fixed-point iterations, the rotation and the reprojection of every
point in one pass.  On a CPU tensor it is the plain version,
``undistort_points_reference``."""
from __future__ import annotations

import torch

from . import _cuda

_UNDISTORT_ITERS = 20
_MODELS = {"radtan": 0, "equidistant": 1}


def pixel_to_normalized(pts: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    return (pts - intrinsics[2:]) / intrinsics[:2]


def normalized_to_pixel(pts: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    return pts * intrinsics[:2] + intrinsics[2:]


def radtan_distort_normalized(pts: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort_normalized(pts_d: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Invert radtan distortion by fixed-point iteration (OpenCV-style)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    xd, yd = pts_d[..., 0], pts_d[..., 1]
    x, y = xd, yd
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def equidistant_distort_normalized(pts: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    x, y = pts[..., 0], pts[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-16))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return pts * (theta_d / r)[..., None]


def equidistant_undistort_normalized(pts_d: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    k1, k2, k3, k4 = dist[0], dist[1], dist[2], dist[3]
    xd, yd = pts_d[..., 0], pts_d[..., 1]
    theta_d = torch.sqrt(torch.clamp(xd * xd + yd * yd, min=1e-16))
    theta = theta_d
    for _ in range(_UNDISTORT_ITERS):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return pts_d * (torch.tan(theta) / theta_d)[..., None]


def undistort_points_reference(
    pts: torch.Tensor,
    intrinsics: torch.Tensor,
    dist: torch.Tensor,
    model: str = "radtan",
    R: torch.Tensor | None = None,
    new_intrinsics: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of ``undistort_points``: the chain of tensor ops, about
    28 an iteration."""
    xn = pixel_to_normalized(pts, intrinsics)
    if model == "equidistant":
        xu = equidistant_undistort_normalized(xn, dist)
    else:
        xu = radtan_undistort_normalized(xn, dist)
    if R is not None:
        rays = torch.cat([xu, torch.ones_like(xu[..., :1])], dim=-1)
        rays = torch.einsum("ij,...j->...i", R, rays)
        xu = rays[..., :2] / rays[..., 2:3]
    if new_intrinsics is not None:
        xu = normalized_to_pixel(xu, new_intrinsics)
    return xu


def undistort_points(
    pts: torch.Tensor,
    intrinsics: torch.Tensor,
    dist: torch.Tensor,
    model: str = "radtan",
    R: torch.Tensor | None = None,
    new_intrinsics: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pixel points -> undistorted normalized points, optionally rotated by
    ``R`` and reprojected with ``new_intrinsics``.  ``model`` 'equidistant'
    inverts the equidistant model, any other name radtan.  Every tensor lies
    on the points' device in their dtype."""
    given = [t for t in (intrinsics, dist, R, new_intrinsics) if t is not None]
    if any(t.device != pts.device for t in given):
        raise ValueError("undistort_points: points, intrinsics, dist, R and new_intrinsics must lie on one device")
    if any(t.dtype != pts.dtype for t in given):
        raise TypeError(f"undistort_points: intrinsics, dist, R and new_intrinsics must be in the points' {pts.dtype}")
    if pts.device.type == "cpu":
        return undistort_points_reference(pts, intrinsics, dist, model, R, new_intrinsics)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    if pts.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"undistort_points takes float32 or float64 points, got {pts.dtype}")
    shapes = ((intrinsics, (4,)), (dist, (4,)), (R, (3, 3)), (new_intrinsics, (4,)))
    if pts.dim() == 0 or pts.shape[-1] != 2 or any(t is not None and t.shape != s for t, s in shapes):
        raise ValueError("undistort_points takes (..., 2) points, (4,) intrinsics, dist and new_intrinsics "
                         "and a (3, 3) R")
    out = torch.empty(pts.shape, dtype=pts.dtype, device=pts.device)
    n = pts.numel() // 2
    if n == 0:  # the kernel launches nothing for it, so nothing is counted
        return out
    pts, intrinsics, dist = pts.contiguous(), intrinsics.contiguous(), dist.contiguous()
    R = None if R is None else R.contiguous()
    new_intrinsics = None if new_intrinsics is None else new_intrinsics.contiguous()
    _cuda.launch(
        "undistort_points", pts.data_ptr(), intrinsics.data_ptr(), dist.data_ptr(),
        None if R is None else R.data_ptr(), None if new_intrinsics is None else new_intrinsics.data_ptr(),
        out.data_ptr(), n, _MODELS.get(model, 0), _UNDISTORT_ITERS, int(pts.dtype == torch.float64),
        torch.cuda.current_stream(pts.device).cuda_stream,
    )
    return out


def distort_points(
    pts_normalized: torch.Tensor,
    intrinsics: torch.Tensor,
    dist: torch.Tensor,
    model: str = "radtan",
) -> torch.Tensor:
    """Normalized coordinates -> distorted pixel coordinates."""
    if model == "equidistant":
        xd = equidistant_distort_normalized(pts_normalized, dist)
    else:
        xd = radtan_distort_normalized(pts_normalized, dist)
    return normalized_to_pixel(xd, intrinsics)


def project_to_stereo_normalized(p_c0: torch.Tensor, R_c0_c1: torch.Tensor, t_c0_c1: torch.Tensor):
    """Project cam0-frame points to both cameras' normalized image planes.

    ``p_c1 = R_c0_c1 p_c0 + t_c0_c1`` (Kalibr T_cn_cnm1 convention, see
    config.StereoCalib).  Returns ((..., 2) cam0, (..., 2) cam1, both
    depths)."""
    p_c1 = (R_c0_c1 @ p_c0[..., None])[..., 0] + t_c0_c1
    z0 = p_c0[..., 2]
    z1 = p_c1[..., 2]
    return p_c0[..., :2] / z0[..., None], p_c1[..., :2] / z1[..., None], z0, z1
