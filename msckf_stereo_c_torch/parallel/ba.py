"""Batch bundle adjustment (Schur-complement Gauss-Newton) and its sharded
form over ``torch.distributed`` (port of
``msckf_stereo_c_tpu/parallel/ba.py``).

Keyframe poses and landmarks from a VIO run are refined by batch BA.  Each
rank holds a block of landmarks (and their observations) and the
replicated poses; it reduces its landmarks' contributions to the (6F x 6F)
pose system, an ``all_reduce`` sums the Schur complement over the ranks,
every rank solves the pose system, and landmark back-substitution stays
with the rank that owns the landmark.

Measurement model: stereo-normalized observations z = [u0 v0 u1 v1] of
landmark j from keyframe i (world->cam0 rotation R_i, camera position t_i,
static stereo extrinsic p_c1 = R01 p_c0 + t01), the filter's measurement
without its observability constraint.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.linalg import cho_solve, cholesky_nan, inv3x3
from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion
from .collectives import all_reduce_sum, block, resolve_group


class BAProblem(NamedTuple):
    cam_q: torch.Tensor  # (F, 4) JPL world->cam0
    cam_p: torch.Tensor  # (F, 3) cam0 position in world
    landmarks: torch.Tensor  # (L, 3)
    obs: torch.Tensor  # (L, F, 4) stereo-normalized observations
    mask: torch.Tensor  # (L, F) bool
    R_c0_c1: torch.Tensor  # (3, 3)
    t_c0_c1: torch.Tensor  # (3,)


def _residual_jacobians(cam_q, cam_p, p_w, z, R01, t01):
    """Stereo reprojection residual and Jacobians of (landmark, keyframe)
    pairs, broadcast over leading dims (``_local_blocks`` passes (1, F)
    poses against (L, 1) landmarks).  Returns r (..., 4), J_pose (..., 4, 6)
    [dtheta, dp] and J_lm (..., 4, 3)."""
    R0 = jpl_to_rot(cam_q)
    R1 = R01 @ R0
    p_c0 = (R0 @ (p_w - cam_p)[..., None])[..., 0]
    p_c1 = p_c0 @ R01.T + t01
    x0, y0, z0 = p_c0.unbind(-1)
    x1, y1, z1 = p_c1.unbind(-1)
    z0 = torch.where(torch.abs(z0) > 1e-9, z0, torch.full_like(z0, 1e-9))
    z1 = torch.where(torch.abs(z1) > 1e-9, z1, torch.full_like(z1, 1e-9))

    r = torch.stack([x0 / z0, y0 / z0, x1 / z1, y1 / z1], dim=-1) - z

    zero = torch.zeros_like(z0)
    dz0 = torch.stack([
        torch.stack([1 / z0, zero, -x0 / (z0 * z0)], -1),
        torch.stack([zero, 1 / z0, -y0 / (z0 * z0)], -1),
        torch.stack([zero, zero, zero], -1),
        torch.stack([zero, zero, zero], -1),
    ], dim=-2)
    dz1 = torch.stack([
        torch.stack([zero, zero, zero], -1),
        torch.stack([zero, zero, zero], -1),
        torch.stack([1 / z1, zero, -x1 / (z1 * z1)], -1),
        torch.stack([zero, 1 / z1, -y1 / (z1 * z1)], -1),
    ], dim=-2)

    # d p_c0 / d[dtheta, dp] = [skew(p_c0), -R0] (the filter's error
    # convention).
    S = skew(p_c0)
    dpc0 = torch.cat([S, (-R0).expand(S.shape)], dim=-1)  # (..., 3, 6)
    dpc1 = torch.cat([R01 @ S, (-R1).expand(S.shape)], dim=-1)
    J_pose = dz0 @ dpc0 + dz1 @ dpc1
    J_lm = dz0 @ R0 + dz1 @ R1
    return r, J_pose, J_lm


def _local_blocks(prob: BAProblem, damping):
    """One rank's reduction: (Hpp (F, F, 6, 6), bp (F, 6), Hll^-1, W, bl,
    cost)."""
    dtype = prob.landmarks.dtype
    F = prob.mask.shape[1]
    r, Jp, Jl = _residual_jacobians(
        prob.cam_q[None], prob.cam_p[None], prob.landmarks[:, None], prob.obs,
        prob.R_c0_c1, prob.t_c0_c1,
    )  # (L, F, 4), (L, F, 4, 6), (L, F, 4, 3)
    m = prob.mask.to(dtype)
    Jp = Jp * m[..., None, None]
    Jl = Jl * m[..., None, None]
    r = r * m[..., None]

    eye3 = torch.eye(3, dtype=dtype, device=Jl.device)
    Hll = torch.einsum("lfab,lfac->lbc", Jl, Jl) + damping * eye3
    Hll_inv = inv3x3(Hll)
    W = torch.einsum("lfab,lfac->lfbc", Jp, Jl)  # (L, F, 6, 3) pose-landmark
    bl = torch.einsum("lfab,lfa->lb", Jl, r)  # (L, 3)
    bp = torch.einsum("lfab,lfa->fb", Jp, r)  # (F, 6)

    # Schur contributions to the pose system.
    WHinv = torch.einsum("lfab,lbc->lfac", W, Hll_inv)  # (L, F, 6, 3)
    Hpp_diag = torch.einsum("lfab,lfac->fbc", Jp, Jp)  # (F, 6, 6)
    Hpp = -torch.einsum("lfab,lgcb->fgac", WHinv, W)  # (F, F, 6, 6)
    ar = torch.arange(F, device=Hpp.device)
    Hpp.index_put_((ar, ar), Hpp_diag, accumulate=True)
    bp_red = bp - torch.einsum("lfab,lb->fa", WHinv, bl)

    cost = torch.sum(r * r)
    return Hpp, bp_red, Hll_inv, W, bl, cost


def _apply_pose_delta(cam_q, cam_p, delta):
    """delta (F, 6) = [dtheta, dp]; left-multiplicative JPL update."""
    return quat_multiply(small_angle_quaternion(delta[:, :3]), cam_q), cam_p + delta[:, 3:6]


def _solve_poses(Hpp, bp, damping, gauge_fix: int = 1):
    """Dense pose solve with the first ``gauge_fix`` poses clamped by a huge
    prior (gauge).  A system that does not factor gives NaN, with no host
    read (``ops/linalg.py:cholesky_nan``)."""
    F = Hpp.shape[0]
    n = 6 * F
    H = Hpp.permute(0, 2, 1, 3).reshape(n, n)
    H = H + damping * torch.eye(n, dtype=H.dtype, device=H.device)
    gmask = (torch.arange(n, device=H.device) < 6 * gauge_fix).to(H.dtype)
    H = H + torch.diag(gmask * 1e12)
    delta = cho_solve(cholesky_nan(H), bp.reshape(n, 1))
    return -delta.reshape(F, 6)  # GN step: delta = -H^-1 b


def _iterate(prob: BAProblem, iters: int, damping: float, group):
    """``iters`` Gauss-Newton steps of this rank's landmark block, the pose
    system summed over ``group`` (None: this block is the whole problem).
    The costs stay on the device: no host read inside the loop."""
    q, p, lms = prob.cam_q, prob.cam_p, prob.landmarks
    costs = []
    for _ in range(iters):
        pr = prob._replace(cam_q=q, cam_p=p, landmarks=lms)
        Hpp, bp, Hll_inv, W, bl, cost = _local_blocks(pr, damping)
        Hpp, bp, cost = all_reduce_sum((Hpp, bp, cost), group)
        dpose = _solve_poses(Hpp, bp, damping)
        # Landmark back-substitution: dl = -Hll^-1 (bl + W^T dpose).
        Wt_dp = torch.einsum("lfab,fa->lb", W, dpose)
        dl = -torch.einsum("lbc,lc->lb", Hll_inv, bl + Wt_dp)
        q, p = _apply_pose_delta(q, p, dpose)
        lms = lms + dl
        costs.append(cost)
    return prob._replace(cam_q=q, cam_p=p, landmarks=lms), torch.stack(costs)


def ba_gauss_newton(prob: BAProblem, iters: int = 10, damping: float = 1e-6):
    """One-process batch BA (the oracle for the sharded runner).  Returns
    the refined problem and the cost before each step (iters,)."""
    return _iterate(prob, iters, damping, None)


def shard_ba_problem(prob: BAProblem, world: int, rank: int) -> BAProblem:
    """``rank``'s block of landmarks (``collectives.block``) with the
    replicated poses; the last blocks are padded with unobserved
    (``mask=False``) landmarks, which add nothing to the pose system."""
    L = prob.landmarks.shape[0]
    s, e, size = block(L, world, rank)

    def rows(x, fill):
        x = x[s:min(e, L)]
        pad = size - x.shape[0]
        if pad:
            x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])
        return x

    return prob._replace(
        landmarks=rows(prob.landmarks, 0.0), obs=rows(prob.obs, 0.0), mask=rows(prob.mask, False)
    )


def make_distributed_ba(group=None, iters: int = 10, damping: float = 1e-6):
    """The sharded BA runner: ``run(block)`` takes this rank's landmark
    block (``shard_ba_problem``) and the replicated poses, sums the pose
    system over ``group``'s ranks each iteration, and returns the refined
    block (its landmarks; the poses replicated) and the summed costs.
    ``group=None`` is the default group, or the one-process solve when no
    process group is initialised."""
    group, _, _ = resolve_group(group)

    def run(prob: BAProblem):
        return _iterate(prob, iters, damping, group)

    return run


def problem_from_vio(
    cam_q: np.ndarray,
    cam_p: np.ndarray,
    landmarks: np.ndarray,
    obs: np.ndarray,
    mask: np.ndarray,
    R_c0_c1: np.ndarray,
    t_c0_c1: np.ndarray,
    dtype=torch.float64,
    device=None,
) -> BAProblem:
    """The problem as tensors on ``device`` (the CUDA card when None; raises
    without CUDA unless a device is named)."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return BAProblem(
        cam_q=t(cam_q), cam_p=t(cam_p), landmarks=t(landmarks), obs=t(obs),
        mask=torch.as_tensor(np.asarray(mask, bool), device=device),
        R_c0_c1=t(R_c0_c1), t_c0_c1=t(t_c0_c1),
    )
