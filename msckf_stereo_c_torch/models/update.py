"""Multi-state-constraint measurement update, Schur path with Newton-Schulz
solves (port of ``msckf_stereo_c_tpu/models/update.py``, the functions the
bench configuration runs).

Per-(track, camera) 4x6 / 4x3 Jacobian blocks with the observability
constraint are computed for the whole (K tracks x M slots) grid at once;
gating and the EKF update marginalize the feature positions through an
orthonormal basis of each track's H_f, with no QR and no factorization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import inv3x3, ns_posdef_inverse
from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion
from .state import CamStates, FilterState


class TrackBlocks(NamedTuple):
    H_x: torch.Tensor  # (K, M, 4, 6)
    H_f: torch.Tensor  # (K, M, 4, 3)
    r: torch.Tensor  # (K, M, 4)
    obs_mask: torch.Tensor  # (K, M)


def track_blocks(
    pos_w: torch.Tensor,  # (K, 3)
    obs: torch.Tensor,  # (K, M, 4)
    obs_mask: torch.Tensor,  # (K, M)
    cams: CamStates,
    gravity: torch.Tensor,
    R_c0_c1: torch.Tensor,
    t_c0_c1: torch.Tensor,
) -> TrackBlocks:
    """OC-projected stereo reprojection Jacobian blocks for every (track,
    camera) pair (reference measurementJacobian), masked with ``where``:
    masked pairs may carry inf/NaN from degenerate triangulations."""
    dtype = pos_w.dtype
    K, M, _ = obs.shape
    R_w_c0 = jpl_to_rot(cams.q)  # (M, 3, 3)
    R_w_c1 = R_c0_c1 @ R_w_c0
    t_c1_w = cams.p - (R_w_c1.transpose(-1, -2) @ t_c0_c1)  # (M, 3)

    d0 = pos_w[:, None, :] - cams.p[None]  # (K, M, 3)
    d1 = pos_w[:, None, :] - t_c1_w[None]
    p_c0 = torch.einsum("mij,kmj->kmi", R_w_c0, d0)
    p_c1 = torch.einsum("mij,kmj->kmi", R_w_c1, d1)
    z0 = torch.where(torch.abs(p_c0[..., 2]) > 1e-9, p_c0[..., 2], 1e-9)
    z1 = torch.where(torch.abs(p_c1[..., 2]) > 1e-9, p_c1[..., 2], 1e-9)

    dz_dpc0 = torch.zeros((K, M, 4, 3), dtype=dtype, device=pos_w.device)
    dz_dpc0[..., 0, 0] = 1.0 / z0
    dz_dpc0[..., 1, 1] = 1.0 / z0
    dz_dpc0[..., 0, 2] = -p_c0[..., 0] / (z0 * z0)
    dz_dpc0[..., 1, 2] = -p_c0[..., 1] / (z0 * z0)
    dz_dpc1 = torch.zeros((K, M, 4, 3), dtype=dtype, device=pos_w.device)
    dz_dpc1[..., 2, 0] = 1.0 / z1
    dz_dpc1[..., 3, 1] = 1.0 / z1
    dz_dpc1[..., 2, 2] = -p_c1[..., 0] / (z1 * z1)
    dz_dpc1[..., 3, 2] = -p_c1[..., 1] / (z1 * z1)

    sk0 = skew(p_c0)  # (K, M, 3, 3)
    dpc0_dxc = torch.cat([sk0, (-R_w_c0).expand(K, M, 3, 3)], dim=-1)
    dpc1_dxc = torch.cat([R_c0_c1 @ sk0, (-R_w_c1).expand(K, M, 3, 3)], dim=-1)
    H_x = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc  # (K, M, 4, 6)

    # Observability constraint: project out u (gravity rotation + position).
    u = torch.cat(
        [
            (jpl_to_rot(cams.q_null) @ gravity).expand(K, M, 3),
            skew(pos_w[:, None, :] - cams.p_null[None]) @ gravity,
        ],
        dim=-1,
    )  # (K, M, 6)
    Hu = (H_x @ u[..., None])[..., 0]  # (K, M, 4)
    H_x = H_x - Hu[..., :, None] * u[..., None, :] / torch.sum(u * u, dim=-1)[..., None, None]
    H_f = -H_x[..., 3:6]
    zhat = torch.stack(
        [p_c0[..., 0] / z0, p_c0[..., 1] / z0, p_c1[..., 0] / z1, p_c1[..., 1] / z1], dim=-1
    )
    r = obs - zhat

    m = obs_mask[..., None, None]
    return TrackBlocks(
        H_x=torch.where(m, H_x, 0.0),
        H_f=torch.where(m, H_f, 0.0),
        r=torch.where(obs_mask[..., None], r, 0.0),
        obs_mask=obs_mask,
    )


def _feature_basis(blocks: TrackBlocks) -> torch.Tensor:
    """(K, 4M, 3) orthonormal basis of col(H_f) per track by modified
    Gram-Schmidt over the three columns."""
    K, M = blocks.obs_mask.shape
    Fm = blocks.H_f.reshape(K, 4 * M, 3)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)

    def dot(a, b):
        return torch.sum(a * b, dim=-1, keepdim=True)

    q0 = unit(Fm[..., 0])
    q1 = unit(Fm[..., 1] - dot(q0, Fm[..., 1]) * q0)
    q2 = unit(Fm[..., 2] - dot(q0, Fm[..., 2]) * q0 - dot(q1, Fm[..., 2]) * q1)
    return torch.stack([q0, q1, q2], dim=-1)


def _projected_information(blocks: TrackBlocks, use_mask: torch.Tensor):
    """Accumulated information of the selected tracks with the features
    marginalized, over the blocks' camera slots: the Gram matrix of the
    projected rows B = (I - Q1 Q1^T) H, kept in per-camera blocks (PSD to
    rounding even in f32).  Returns (Ncc (6Mc, 6Mc), ycc (6Mc,))."""
    K, Mc = blocks.obs_mask.shape
    use = use_mask.to(blocks.H_x.dtype)
    Q1 = _feature_basis(blocks).reshape(K, Mc, 4, 3)
    W = torch.einsum("kjac,kjab->kjcb", Q1, blocks.H_x)  # Q1_j^T H_xj
    B = -torch.einsum("kiac,kjcb->kijab", Q1, W)  # (K, Mc, Mc, 4, 6)
    ar = torch.arange(Mc, device=B.device)
    B[:, ar, ar] += blocks.H_x
    rho = torch.einsum("kiac,kia->kc", Q1, blocks.r)
    r_proj = blocks.r - torch.einsum("kiac,kc->kia", Q1, rho)
    Ncc = torch.einsum("k,kijab,kiJaB->jbJB", use, B, B).reshape(6 * Mc, 6 * Mc)
    ycc = torch.einsum("k,kijab,kia->jb", use, B, r_proj).reshape(6 * Mc)
    return Ncc, ycc


def schur_information_cam(blocks: TrackBlocks, use_mask: torch.Tensor):
    """Camera-block information (Ncc (6M, 6M), ycc (6M,))."""
    return _projected_information(blocks, use_mask)


def cam_cov_blocks(P: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
    """(Mc, Mc, 6, 6) camera-camera covariance blocks of ``cam_idx``."""
    M = (P.shape[0] - 21) // 6
    Pc = P[21:, 21:].reshape(M, 6, M, 6).permute(0, 2, 1, 3)
    return Pc[cam_idx][:, cam_idx]


def _constrained_gamma(Mk, Q1, r, sigma2, ns_iters: int):
    """gamma = r^T w with M w + Q1 lam = r, Q1^T w = 0, by block
    elimination with the Newton-Schulz inverse of M."""
    X = ns_posdef_inverse(Mk, sigma2, ns_iters)
    Minv_r = torch.einsum("krs,ks->kr", X, r)
    Minv_Q = X @ Q1
    QMQ = torch.einsum("kra,krb->kab", Q1, Minv_Q)
    QMr = torch.einsum("kra,kr->ka", Q1, Minv_r)
    eye3 = torch.eye(3, dtype=Mk.dtype, device=Mk.device)
    lam = torch.einsum("kab,kb->ka", inv3x3(QMQ + 1e-12 * eye3), QMr)
    w = Minv_r - torch.einsum("kra,ka->kr", Minv_Q, lam)
    return torch.einsum("kr,kr->k", r, w)


def _gamma(blocks: TrackBlocks, Pc: torch.Tensor, sigma2, ns_iters: int) -> torch.Tensor:
    K, Mc = blocks.obs_mask.shape
    R4 = 4 * Mc
    MP = torch.einsum("kiab,ijbc,kjdc->kijad", blocks.H_x, Pc, blocks.H_x)
    Mk = MP.permute(0, 1, 3, 2, 4).reshape(K, R4, R4)
    Mk = Mk + sigma2 * torch.eye(R4, dtype=Mk.dtype, device=Mk.device)
    Q1 = _feature_basis(blocks)
    return _constrained_gamma(Mk, Q1, blocks.r.reshape(K, R4), sigma2, ns_iters)


def schur_gating(blocks: TrackBlocks, P: torch.Tensor, sigma2, ns_iters: int) -> torch.Tensor:
    """Mahalanobis gamma per track of the nullspace-projected system."""
    M = blocks.obs_mask.shape[1]
    Pc = P[21:, 21:].reshape(M, 6, M, 6).permute(0, 2, 1, 3)
    return _gamma(blocks, Pc, sigma2, ns_iters)


def schur_gating_compact(blocks: TrackBlocks, Pc: torch.Tensor, sigma2, ns_iters: int):
    """``schur_gating`` on camera-compacted blocks with their (Mc, Mc, 6, 6)
    covariance blocks ``Pc``."""
    return _gamma(blocks, Pc, sigma2, ns_iters)


def _ns_update(state: FilterState, Ncc, ycc, P_cols, P_cc, sigma2, ns_iters: int) -> FilterState:
    """Factorization-free information-form EKF update:
    Gcc = (s2 I + Ncc Pcc)^-1 Ncc, delta = P[:, c] (s2 I + Ncc Pcc)^-1 ycc,
    P' = P - P[:, c] Gcc P[c, :]."""
    Rk = Ncc.shape[0]
    Mu = sigma2 * torch.eye(Rk, dtype=Ncc.dtype, device=Ncc.device) + Ncc @ P_cc
    W = ns_posdef_inverse(Mu, sigma2, ns_iters)
    Gcc = W @ Ncc
    Gcc = 0.5 * (Gcc + Gcc.T)
    delta = P_cols @ (W @ ycc)
    P_new = state.P - P_cols @ Gcc @ P_cols.T
    P_new = 0.5 * (P_new + P_new.T)
    state = apply_correction(state, delta)
    return state._replace(P=P_new)


def measurement_update_schur(
    state: FilterState, blocks: TrackBlocks, use_mask: torch.Tensor, sigma2, ns_iters: int
) -> FilterState:
    """EKF update from the accumulated Schur information over all camera
    slots."""
    Ncc, ycc = schur_information_cam(blocks, use_mask)
    P = state.P
    return _ns_update(state, Ncc, ycc, P[:, 21:], P[21:, 21:], sigma2, ns_iters)


def measurement_update_schur_compact(
    state: FilterState,
    blocks: TrackBlocks,
    use_mask: torch.Tensor,
    sigma2,
    cam_idx: torch.Tensor,
    ns_iters: int,
) -> FilterState:
    """Camera-compacted Schur update: the information lives in the 6*Mc
    state columns of ``cam_idx``."""
    Mc = cam_idx.shape[0]
    Ncc, ycc = _projected_information(blocks, use_mask)
    cols = (21 + 6 * cam_idx[:, None] + torch.arange(6, device=cam_idx.device)[None]).reshape(6 * Mc)
    P_cols = state.P[:, cols]
    return _ns_update(state, Ncc, ycc, P_cols, P_cols[cols], sigma2, ns_iters)


def apply_correction(state: FilterState, delta: torch.Tensor) -> FilterState:
    """Inject the error-state correction into the nominal state."""
    imu = state.imu
    M = state.cams.q.shape[0]
    dq_imu = small_angle_quaternion(delta[0:3])
    dq_ext = small_angle_quaternion(delta[15:18])
    new_imu = imu._replace(
        q=quat_multiply(dq_imu, imu.q),
        bg=imu.bg + delta[3:6],
        v=imu.v + delta[6:9],
        ba=imu.ba + delta[9:12],
        p=imu.p + delta[12:15],
        R_imu_cam0=jpl_to_rot(dq_ext) @ imu.R_imu_cam0,
        t_cam0_imu=imu.t_cam0_imu + delta[18:21],
    )
    cam_delta = delta[21:].reshape(M, 6)
    active = (torch.arange(M, device=delta.device) < state.num_cams)[:, None]
    q_new = quat_multiply(small_angle_quaternion(cam_delta[:, 0:3]), state.cams.q)
    p_new = state.cams.p + cam_delta[:, 3:6]
    cams = state.cams._replace(
        q=torch.where(active, q_new, state.cams.q),
        p=torch.where(active, p_new, state.cams.p),
    )
    return state._replace(imu=new_imu, cams=cams)
