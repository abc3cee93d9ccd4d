"""Two-point translation RANSAC for temporal outlier rejection, per lane
(port of ``msckf_stereo_c_tpu/ops/ransac.py``).

With the IMU rotation compensated, the epipolar constraint of a point pair
is ``coeff_i . t = 0`` with ``coeff_i = [dy_i, -dx_i, x1 y2 - y1 x2]``; two
pairs fix the translation direction.  All ``NUM_HYPOTHESES`` hypotheses
are drawn up front and scored at once (hypotheses x points), and the
largest inlier set wins: no data-dependent iteration and no host read.

The JAX package draws its index pairs with ``jax.random`` (threefry), which
the port cannot reproduce, so ``two_point_ransac`` takes the two raw draw
vectors.  The front end makes them with ``ransac_draws``: a counter hash of
(17, the lane's ``next_fid``, camera, hypothesis) on the device.

While a profiler records, each call appends to ``ransac_work_log`` the
matches it rejected in each lane (``valid & ~mask`` summed on the device,
an int32 (B,) tensor; no host read); off the profiler it appends nothing.
"""
from __future__ import annotations

from collections import deque
from typing import Tuple

import torch

from ..utils.timing import profiling
from .camera import undistort_points
from .linalg import solve2x2

NUM_HYPOTHESES = 16  # >= ceil(log(1-0.99)/log(1-0.49)) = 7; extra is free
_MASK32 = 0xFFFFFFFF
ransac_work_log: deque = deque(maxlen=256)  # per call while profiling: rejected matches a lane, int32 (B,)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash of int64 values in [0, 2^32): xor-shifts and
    odd multipliers below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def ransac_draws(next_fid: torch.Tensor, camera: int, n: int = NUM_HYPOTHESES) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two raw draw vectors (B, n) in [0, 2^30) for each lane of
    ``next_fid`` (B,): a counter hash of (17, next_fid, camera, h), made
    where ``next_fid`` lies, with no generator state."""
    dev = next_fid.device
    s = _hash32(torch.full_like(next_fid, 17, dtype=torch.int64))
    s = _hash32(s ^ (next_fid.to(torch.int64) & _MASK32))
    s = _hash32(s ^ camera)
    h = torch.arange(2 * n, device=dev, dtype=torch.int64)
    x = _hash32(s[:, None] ^ h) >> 2
    return x[:, :n], x[:, n:]


def two_point_ransac(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    valid: torch.Tensor,
    R_p_c: torch.Tensor,
    intrinsics: torch.Tensor,
    dist: torch.Tensor,
    draw1: torch.Tensor,
    draw2: torch.Tensor,
    model: str = "radtan",
    inlier_error: float = 3.0,
) -> torch.Tensor:
    """Refined inlier mask (B, N), a subset of ``valid``, per lane:
    previous-frame pixels ``pts1`` and current ones ``pts2`` (B, N, 2),
    the rotation previous -> current camera ``R_p_c`` (B, 3, 3), and the raw
    draws (B, H) in [0, 2^30) that ``jax.random.randint(k, (H,), 0, 1 << 30)``
    gives the JAX version for the two halves of its split key."""
    dtype = pts1.dtype
    N = pts1.shape[1]
    npu = 2.0 / (intrinsics[0] + intrinsics[1])

    p1 = undistort_points(pts1, intrinsics, dist, model=model)
    p2 = undistort_points(pts2, intrinsics, dist, model=model)
    # Rotation compensation, homogeneous and not re-normalized; elementwise
    # products, so never TF32.
    R = R_p_c[:, None]
    p1r = torch.stack([p1[..., 0] * R[..., i, 0] + p1[..., 1] * R[..., i, 1] + R[..., i, 2] for i in (0, 1)], -1)

    # Scale normalization over the valid points.
    vf = valid.to(dtype)
    norms = torch.linalg.norm(p1r, dim=-1) + torch.linalg.norm(p2, dim=-1)
    n_valid = torch.clamp(torch.sum(vf, -1), min=1.0)
    sf = (2.0 * n_valid) / torch.clamp(torch.sum(norms * vf, -1), min=1e-12) * (2.0**0.5)
    p1s = p1r * sf[:, None, None]
    p2s = p2 * sf[:, None, None]
    npu = npu * sf  # (B,)

    diff = p1s - p2s
    dist_pt = torch.linalg.norm(diff, dim=-1)
    raw = valid & (dist_pt <= 50.0 * npu[:, None])
    raw_cnt = torch.sum(raw, -1)
    mean_dist = torch.sum(torch.where(raw, dist_pt, torch.zeros_like(dist_pt)), -1) / torch.clamp(
        raw_cnt.to(dtype), min=1.0
    )
    coeff = torch.stack(
        [diff[..., 1], -diff[..., 0], p1s[..., 0] * p2s[..., 1] - p1s[..., 1] * p2s[..., 0]], dim=-1
    )

    # Index pairs among the raw inliers: raw first (stable), draw within
    # the count, the second index a nonzero offset from the first.
    order = torch.argsort((~raw).to(torch.int32), dim=-1, stable=True)
    cnt = torch.clamp(raw_cnt, min=1)[:, None]
    u1 = draw1 % cnt
    du = 1 + draw2 % torch.clamp(raw_cnt - 1, min=1)[:, None]
    u2 = (u1 + du) % cnt
    i1 = torch.take_along_dim(order, u1, dim=-1)
    i2 = torch.take_along_dim(order, u2, dim=-1)
    c1 = torch.take_along_dim(coeff, i1[..., None], dim=1)  # (B, H, 3)
    c2 = torch.take_along_dim(coeff, i2[..., None], dim=1)
    # The base column of the smallest l1 norm; solve for the other two.
    base = torch.argmin(torch.abs(c1) + torch.abs(c2), dim=-1)

    def solve_for(base_col, a_col, b_col):
        A = torch.stack(
            [torch.stack([c1[..., a_col], c1[..., b_col]], -1), torch.stack([c2[..., a_col], c2[..., b_col]], -1)],
            -2,
        )
        return solve2x2(A, -torch.stack([c1[..., base_col], c2[..., base_col]], -1))

    s0, s1, s2 = solve_for(0, 1, 2), solve_for(1, 0, 2), solve_for(2, 0, 1)
    one = torch.ones_like(s0[..., 0])
    m0 = torch.stack([one, s0[..., 0], s0[..., 1]], -1)
    m1 = torch.stack([s1[..., 0], one, s1[..., 1]], -1)
    m2 = torch.stack([s2[..., 0], s2[..., 1], one], -1)
    models = torch.where((base == 0)[..., None], m0, torch.where((base == 1)[..., None], m1, m2))

    c, m = coeff[:, :, None, :], models[:, None, :, :]
    err = torch.abs(c[..., 0] * m[..., 0] + c[..., 1] * m[..., 1] + c[..., 2] * m[..., 2])  # (B, N, H)
    inl = raw[..., None] & (err < inlier_error * npu[:, None, None])
    counts = torch.sum(inl, dim=1)  # (B, H)
    counts = torch.where(counts >= 0.2 * N, counts, torch.zeros_like(counts))
    best = torch.argmax(counts, dim=-1, keepdim=True)  # first of equal counts
    ransac_mask = torch.take_along_dim(inl, best[:, None, :], dim=2)[..., 0] & (
        torch.take_along_dim(counts, best, dim=-1) > 0
    )

    # Degenerate motion (no translation): a distance gate.
    degen_mask = raw & (dist_pt <= inlier_error * npu[:, None])
    out = torch.where((mean_dist < npu)[:, None], degen_mask, ransac_mask)
    # Too few raw inliers: everything out.
    out = out & (raw_cnt >= 3)[:, None]
    if profiling():
        ransac_work_log.append(torch.sum(valid & ~out, dim=-1, dtype=torch.int32))
    return out
