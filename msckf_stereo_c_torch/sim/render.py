"""Synthetic stereo image rendering for end-to-end frontend testing.

Geometrically consistent world: a smooth procedural texture on a finite
cylinder (walls) + planes (floor/ceiling) is raycast through each camera's
full lens model, and the simulated landmarks are stamped as bright blobs at
their projected positions.  Both cameras therefore see correct parallax at
*all* depths — a background shared verbatim between the two views would let
coarse pyramid levels of the KLT lock onto zero disparity, which is exactly
the failure mode this renderer exists to exercise."""
from __future__ import annotations

import numpy as np

from ..config import EUROC_CALIB, StereoCalib
from .trajectory import SimTrajectory


def _distort_project(p_cam: np.ndarray, intrinsics, dist):
    """cam-frame points -> distorted pixel coordinates (radtan)."""
    fx, fy, cx, cy = intrinsics
    k1, k2, p1, p2 = dist
    x = p_cam[:, 0] / p_cam[:, 2]
    y = p_cam[:, 1] / p_cam[:, 2]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], axis=1)


def _ray_lut(intrinsics, dist, W, H):
    """Per-pixel unit ray directions in the camera frame (undistorted)."""
    fx, fy, cx, cy = intrinsics
    k1, k2, p1, p2 = dist
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)  # (H, W, 3)


class _Texture:
    """Smooth periodic procedural texture over (azimuth, height)."""

    def __init__(self, seed: int, n: int = 10):
        rng = np.random.default_rng(seed)
        self.fa = rng.integers(1, 14, n).astype(np.float64)  # azimuth frequency
        self.fz = rng.uniform(0.3, 2.5, n)
        self.pa = rng.uniform(0, 2 * np.pi, n)
        self.pz = rng.uniform(0, 2 * np.pi, n)
        self.amp = rng.uniform(6.0, 16.0, n)

    def __call__(self, theta: np.ndarray, z: np.ndarray) -> np.ndarray:
        out = np.full(theta.shape, 70.0)
        for fa, fz, pa, pz, a in zip(self.fa, self.fz, self.pa, self.pz, self.amp):
            out += a * np.sin(fa * theta + pa) * np.sin(fz * z + pz)
        return out


def _raycast_background(
    R_c_w: np.ndarray,  # (3,3) cam->world rotation
    o_w: np.ndarray,  # (3,) camera position in world
    rays_cam: np.ndarray,  # (H, W, 3)
    tex: _Texture,
    r_wall: float = 12.0,
    z_cap: float = 8.0,
):
    H, W, _ = rays_cam.shape
    d = rays_cam.reshape(-1, 3) @ R_c_w.T  # world-frame ray directions
    o = o_w[None, :]

    # Cylinder x^2 + y^2 = r_wall^2.
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = 2.0 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1])
    c = o[:, 0] ** 2 + o[:, 1] ** 2 - r_wall**2
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    t_cyl = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)

    # Caps z = +/- z_cap for rays leaving the wall band.
    dz = np.where(np.abs(d[:, 2]) > 1e-9, d[:, 2], 1e-9)
    t_top = (z_cap - o[:, 2]) / dz
    t_bot = (-z_cap - o[:, 2]) / dz

    p_cyl_z = o[:, 2] + t_cyl * d[:, 2]
    use_cyl = (np.abs(p_cyl_z) <= z_cap) & (t_cyl > 0)
    t_cap = np.where(d[:, 2] > 0, t_top, t_bot)
    t = np.where(use_cyl, t_cyl, np.maximum(t_cap, 0.1))

    p = o + t[:, None] * d
    theta = np.arctan2(p[:, 1], p[:, 0])
    # Caps get their own parametrization folded into the same texture.
    zc = np.where(use_cyl, p[:, 2], np.hypot(p[:, 0], p[:, 1]) * np.sign(p[:, 2]) * 0.6)
    return tex(theta, zc).reshape(H, W)


def render_stereo_sequence(
    traj: SimTrajectory,
    landmarks: np.ndarray,
    frame_indices: np.ndarray,
    calib: StereoCalib = EUROC_CALIB,
    min_depth: float = 0.3,
    blob_radius: int = 4,
    seed: int = 5,
    r_wall: float = 12.0,
):
    """Render (T, H, W) float32 image pairs for the given trajectory frames."""
    rng = np.random.default_rng(seed)
    W, H = calib.cam0.resolution
    T_ci0 = calib.cam0.T_cam_imu_mat()
    T01 = calib.T_cam0_cam1_mat()
    T_ci1 = T01 @ T_ci0  # imu -> cam1

    L = landmarks.shape[0]
    amp = rng.uniform(60.0, 140.0, L)
    sx = rng.uniform(1.1, 1.8, L)
    sy = rng.uniform(1.1, 1.8, L)

    tex = _Texture(seed)
    rays0 = _ray_lut(calib.cam0.intrinsics, calib.cam0.distortion_coeffs, W, H)
    rays1 = _ray_lut(calib.cam1.intrinsics, calib.cam1.distortion_coeffs, W, H)

    r = blob_radius
    gy, gx = np.mgrid[-r : r + 1, -r : r + 1]

    out0 = np.empty((len(frame_indices), H, W), np.float32)
    out1 = np.empty((len(frame_indices), H, W), np.float32)

    for k, i in enumerate(frame_indices):
        R_wb, p_b = traj.R_w_b[i], traj.p[i]
        p_imu = (landmarks - p_b) @ R_wb.T
        p_c0 = p_imu @ T_ci0[:3, :3].T + T_ci0[:3, 3]
        p_c1 = p_imu @ T_ci1[:3, :3].T + T_ci1[:3, 3]

        for (T_ci, rays, p_c, intr, dist, out) in (
            (T_ci0, rays0, p_c0, calib.cam0.intrinsics, calib.cam0.distortion_coeffs, out0),
            (T_ci1, rays1, p_c1, calib.cam1.intrinsics, calib.cam1.distortion_coeffs, out1),
        ):
            # Camera pose in world: R_c_w = (R_ci R_wb)^T ; o = p_b + R_wb^T t_ci^-1.
            R_w_c = T_ci[:3, :3] @ R_wb
            R_c_w = R_w_c.T
            o_w = p_b + R_wb.T @ (-T_ci[:3, :3].T @ T_ci[:3, 3])

            img = _raycast_background(R_c_w, o_w, rays, tex, r_wall=r_wall)

            vis = p_c[:, 2] > min_depth
            uv = np.zeros((L, 2))
            uv[vis] = _distort_project(p_c[vis], intr, dist)
            vis &= (uv[:, 0] > r + 3) & (uv[:, 0] < W - r - 4)
            vis &= (uv[:, 1] > r + 3) & (uv[:, 1] < H - r - 4)
            for lm in np.flatnonzero(vis):
                u, v = uv[lm]
                cx_i, cy_i = int(round(u)), int(round(v))
                du = gx + (cx_i - u)
                dv = gy + (cy_i - v)
                blob = amp[lm] * np.exp(
                    -0.5 * ((du / sx[lm]) ** 2 + (dv / sy[lm]) ** 2)
                )
                img[cy_i - r : cy_i + r + 1, cx_i - r : cx_i + r + 1] += blob
            out[k] = np.clip(img, 0, 255).astype(np.float32)

    return out0, out1
