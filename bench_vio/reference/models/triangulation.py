# Frozen copy of msckf_stereo_c_torch/models/triangulation.py at commit 50013dad8c92.
"""Batched inverse-depth Levenberg-Marquardt triangulation (port of
``msckf_stereo_c_tpu/models/triangulation.py``), written out over the
tracks of every sequence lane in place of ``vmap``.

Inputs carry a leading sequence axis B: tracks (B, K, ...) seen from each
lane's own camera window (B, M, ...).  The LM loop runs on the B x K tracks
flattened into one axis.  The JAX loop runs, under ``vmap``, until every
track has converged and keeps the finished ones frozen; here each track's
update is masked the same way and the loop stops once no track of any lane
is active (one host read per iteration for all lanes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import solve3x3
from ..utils.lanes import take
from ..utils.quaternion import jpl_to_rot

_LM_ITERS = 30
_HUBER_EPS = 0.01
_LAMBDA_INIT = 1e-3
_LAMBDA_MIN = 1e-10
_LAMBDA_MAX = 1e12
_PRECISION = 5e-7


class TriangulationResult(NamedTuple):
    pos_w: torch.Tensor  # (K, 3) world-frame position
    valid: torch.Tensor  # (K,) bool cheirality check over valid poses
    base_slot: torch.Tensor  # (K,) first valid cam slot


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 when none)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _stereo_pose_stack(cam_q, cam_p, obs_valid, R_c0_c1, t_c0_c1):
    """Per-track cam0/cam1 poses re-based to each track's first valid cam0
    frame: R (B, K, 2M, 3, 3), t (B, K, 2M, 3) with x_ci = R_i x_base +
    t_i, plus the base (cam0 -> world) transform and slot."""
    B, K, M = obs_valid.shape
    R_w_c0 = jpl_to_rot(cam_q)
    R_c0_w = R_w_c0.transpose(-1, -2)
    R_c1_c0 = R_c0_c1.T
    t_c1_c0 = -R_c0_c1.T @ t_c0_c1
    R_c1_w = R_c0_w @ R_c1_c0
    t_c1_w = R_c0_w @ t_c1_c0 + cam_p

    i0 = _first_true(obs_valid)
    Rb = take(R_c0_w, i0)  # (B, K, 3, 3)
    tb = take(cam_p, i0)  # (B, K, 3)

    def rel(Rcw, tcw):
        Rwc = Rcw.transpose(-1, -2)  # (B, M, 3, 3)
        twc = -(Rwc @ tcw[..., None])[..., 0]  # (B, M, 3)
        Rrel = torch.einsum("bmij,bkjl->bkmil", Rwc, Rb)
        trel = torch.einsum("bmij,bkj->bkmi", Rwc, tb) + twc[:, None]
        return Rrel, trel

    R0, t0 = rel(R_c0_w, cam_p)
    R1, t1 = rel(R_c1_w, t_c1_w)
    R = torch.stack([R0, R1], dim=3).reshape(B, K, 2 * M, 3, 3)
    t = torch.stack([t0, t1], dim=3).reshape(B, K, 2 * M, 3)
    return R, t, Rb, tb, i0


def _project(R, t, x):
    ones = torch.ones_like(x[:, :1])
    h = torch.einsum("kmij,kj->kmi", R, torch.cat([x[:, :2], ones], dim=1)) + x[:, 2, None, None] * t
    return h


def _cost(R, t, w_valid, x, z):
    h = _project(R, t, x)
    zhat = h[..., :2] / h[..., 2:3]
    e = torch.sum((zhat - z) ** 2, dim=-1)
    return torch.sum(torch.where(w_valid, e, 0.0), dim=-1)


def _normal_equations(R, t, w_valid, x, z):
    """Masked, Huber-weighted J^T J and J^T r per track."""
    h = _project(R, t, x)
    h1, h2, h3 = h[..., 0], h[..., 1], h[..., 2]
    W = torch.cat([R[..., :2], t[..., None]], dim=-1)  # (K, 2M, 3, 3)
    J0 = W[..., 0, :] / h3[..., None] - (h1 / (h3 * h3))[..., None] * W[..., 2, :]
    J1 = W[..., 1, :] / h3[..., None] - (h2 / (h3 * h3))[..., None] * W[..., 2, :]
    r = torch.stack([h1 / h3, h2 / h3], dim=-1) - z
    e = torch.linalg.norm(r, dim=-1)
    w = torch.where(
        e <= _HUBER_EPS, 1.0, torch.sqrt(2.0 * _HUBER_EPS / torch.clamp(e, min=1e-12))
    )
    w2 = torch.where(w_valid, w * w, 0.0)
    J = torch.stack([J0, J1], dim=-2)  # (K, 2M, 2, 3)
    A = torch.einsum("km,kmia,kmib->kab", w2, J, J)
    b = torch.einsum("km,kmia,kmi->ka", w2, J, r)
    return A, b


def triangulate_tracks(
    obs: torch.Tensor,  # (B, K, M, 4) normalized stereo observations
    obs_valid: torch.Tensor,  # (B, K, M)
    cam_q: torch.Tensor,  # (B, M, 4)
    cam_p: torch.Tensor,  # (B, M, 3)
    R_c0_c1: torch.Tensor,
    t_c0_c1: torch.Tensor,
    active: torch.Tensor | None = None,  # (B,) lanes whose tracks iterate
) -> TriangulationResult:
    """Damped LM triangulation of the K tracks of all B lanes at once
    (reference Feature::initializePosition); the tracks of a lane outside
    ``active`` skip the LM steps.  Results are (B, K, ...)."""
    Bl, K0 = obs_valid.shape[:2]
    R, t, Rb, tb, i0 = _stereo_pose_stack(cam_q, cam_p, obs_valid, R_c0_c1, t_c0_c1)
    M = obs.shape[2]
    K = Bl * K0
    obs, obs_valid = obs.reshape(K, M, 4), obs_valid.reshape(K, M)
    R, t, i0 = R.reshape(K, 2 * M, 3, 3), t.reshape(K, 2 * M, 3), i0.reshape(K)
    dtype = obs.dtype
    ar = torch.arange(K, device=obs.device)
    z = obs.reshape(K, 2 * M, 2)  # interleaved cam0, cam1
    w_valid = torch.repeat_interleave(obs_valid, 2, dim=1)

    # Two-view linear depth from the base cam0 ray and the last cam1 view.
    i_last = M - 1 - _first_true(torch.flip(obs_valid, dims=[1]))
    z_first = obs[ar, i0, 0:2]
    z_last = obs[ar, i_last, 2:4]
    Rr = R[ar, 2 * i_last + 1]
    tr = t[ar, 2 * i_last + 1]
    m = (Rr @ torch.cat([z_first, torch.ones_like(z_first[:, :1])], dim=1)[..., None])[..., 0]
    A0 = m[:, 0] - z_last[:, 0] * m[:, 2]
    A1 = m[:, 1] - z_last[:, 1] * m[:, 2]
    b0 = z_last[:, 0] * tr[:, 2] - tr[:, 0]
    b1 = z_last[:, 1] * tr[:, 2] - tr[:, 1]
    depth = (A0 * b0 + A1 * b1) / torch.clamp(A0 * A0 + A1 * A1, min=1e-12)
    p0 = torch.stack([z_first[:, 0] * depth, z_first[:, 1] * depth, depth], dim=-1)

    safe_depth = torch.where(torch.abs(p0[:, 2]) > 1e-8, p0[:, 2], 1.0)
    x = torch.stack([p0[:, 0] / safe_depth, p0[:, 1] / safe_depth, 1.0 / safe_depth], dim=-1)
    cost = _cost(R, t, w_valid, x, z)
    lam = torch.full((K,), _LAMBDA_INIT, dtype=dtype, device=obs.device)
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=obs.device)
    else:
        active = active[:, None].expand(Bl, K0).reshape(K)
    eye3 = torch.eye(3, dtype=dtype, device=obs.device)

    for _ in range(_LM_ITERS):
        A, b = _normal_equations(R, t, w_valid, x, z)
        delta = solve3x3(A + lam[:, None, None] * eye3, b)
        x_new = x - delta
        cost_new = _cost(R, t, w_valid, x_new, z)
        accept = active & (cost_new < cost)
        x = torch.where(accept[:, None], x_new, x)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(
            active,
            torch.where(
                accept,
                torch.clamp(lam * 0.1, min=_LAMBDA_MIN),
                torch.clamp(lam * 10.0, max=_LAMBDA_MAX),
            ),
            lam,
        )
        active = active & (torch.linalg.norm(delta, dim=-1) > _PRECISION)
        # One host read per iteration, for every lane at once, buys JAX's
        # early exit (LM stops once every track has converged).
        if not bool(torch.any(active)):
            break

    inv_rho = 1.0 / torch.where(torch.abs(x[:, 2]) > 1e-12, x[:, 2], 1e-12)
    p_base = torch.stack([x[:, 0] * inv_rho, x[:, 1] * inv_rho, inv_rho], dim=-1)

    # Cheirality: in front of every observing camera.
    depths = (torch.einsum("kmij,kj->kmi", R, p_base) + t)[..., 2]
    valid = torch.all(torch.where(w_valid, depths > 0, True), dim=1)
    valid = valid & (torch.sum(obs_valid, dim=1) >= 2)
    p_base = p_base.reshape(Bl, K0, 3)
    pos_w = (Rb @ p_base[..., None])[..., 0] + tb
    return TriangulationResult(pos_w=pos_w, valid=valid.reshape(Bl, K0), base_slot=i0.reshape(Bl, K0))


def check_motion_tracks(
    obs: torch.Tensor,
    obs_valid: torch.Tensor,
    cam_q: torch.Tensor,
    cam_p: torch.Tensor,
    translation_threshold,
) -> torch.Tensor:
    """Parallax gate per track (B, K): the first->last camera translation's
    component orthogonal to the first observation ray."""
    M = obs.shape[2]
    i0 = _first_true(obs_valid)
    i1 = M - 1 - _first_true(torch.flip(obs_valid, dims=[-1]))
    R0 = jpl_to_rot(take(cam_q, i0))
    first = torch.take_along_dim(obs, i0[..., None, None], dim=2)[:, :, 0, 0:2]
    ray_c = torch.cat([first, torch.ones_like(first[..., :1])], dim=-1)
    ray_c = ray_c / torch.linalg.norm(ray_c, dim=-1, keepdim=True)
    ray_w = (R0.transpose(-1, -2) @ ray_c[..., None])[..., 0]
    translation = take(cam_p, i1) - take(cam_p, i0)
    parallel = torch.sum(translation * ray_w, dim=-1, keepdim=True)
    orthogonal = translation - parallel * ray_w
    return torch.linalg.norm(orthogonal, dim=-1) > translation_threshold


def triangulate_track(obs, obs_valid, cam_q, cam_p, R_c0_c1, t_c0_c1) -> TriangulationResult:
    """One track: obs (M, 4), obs_valid (M,) seen from one window cam_q
    (M, 4), cam_p (M, 3); the one-track view of ``triangulate_tracks``."""
    res = triangulate_tracks(obs[None, None], obs_valid[None, None], cam_q[None], cam_p[None], R_c0_c1, t_c0_c1)
    return TriangulationResult(*(x[0, 0] for x in res))


def check_motion(obs, obs_valid, cam_q, cam_p, translation_threshold) -> torch.Tensor:
    """Parallax gate of one track (feature.hpp:257-287); the one-track
    view of ``check_motion_tracks``.  A negative threshold disables it."""
    return check_motion_tracks(obs[None, None], obs_valid[None, None], cam_q[None], cam_p[None],
                               translation_threshold)[0, 0]
