# Frozen copy of msckf_stereo_c_torch/sim/render.py at commit 50013dad8c92: the ray table and the texture
# that render_torch.py uses; the numpy renderer itself is left out.
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


