"""Multi-state-constraint measurement update (port of
``msckf_stereo_c_tpu/models/update.py``).

Per-(track, camera) 4x6 / 4x3 Jacobian blocks with the observability
constraint are computed for the whole (K tracks x M slots) grid at once.
Two algebras consume them:

* ``method='schur'``: gating and the EKF update marginalize the feature
  positions through an orthonormal basis of each track's H_f, with no QR;
  its solves are Newton-Schulz matmuls (``ns_iters > 0``) or exact
  Cholesky factorizations (``ns_iters == 0``);
* ``method='qr'`` / ``'cholesky'`` (reference featureJacobian and
  measurementUpdate): the stacked rows are projected onto the left
  nullspace of H_f (``track_jacobians``), gated, and compressed into a
  (D, D) square-root measurement by a dense QR or a normal-equation
  Cholesky (``compress_measurements``).

Every tensor carries a leading sequence lane axis B; the solves run batched
over the lanes.  A factorization that fails gives NaN, as in JAX
(``ops/linalg.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.linalg import cho_solve, cholesky_nan, inv3x3, ns_posdef_inverse, qr_r, solve_lower, solve_nan
from ..utils.lie import skew
from ..utils.timing import span
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion
from .state import CamStates, FilterState


class TrackJacobians(NamedTuple):
    H_o: torch.Tensor  # (B, K, 4M, D) nullspace-projected stacked Jacobians
    r_o: torch.Tensor  # (B, K, 4M) projected residuals
    rows_valid: torch.Tensor  # (B, K, 4M) rows that carry information


class TrackBlocks(NamedTuple):
    H_x: torch.Tensor  # (B, K, M, 4, 6)
    H_f: torch.Tensor  # (B, K, M, 4, 3)
    r: torch.Tensor  # (B, K, M, 4)
    obs_mask: torch.Tensor  # (B, K, M)


def track_blocks(
    pos_w: torch.Tensor,  # (B, K, 3)
    obs: torch.Tensor,  # (B, K, M, 4)
    obs_mask: torch.Tensor,  # (B, K, M)
    cams: CamStates,  # (B, M, ...)
    gravity: torch.Tensor,  # (B, 3)
    R_c0_c1: torch.Tensor,
    t_c0_c1: torch.Tensor,
) -> TrackBlocks:
    """OC-projected stereo reprojection Jacobian blocks for every (track,
    camera) pair of every lane (reference measurementJacobian), masked with
    ``where``: masked pairs may carry inf/NaN from degenerate
    triangulations."""
    dtype = pos_w.dtype
    B, K, M, _ = obs.shape
    R_w_c0 = jpl_to_rot(cams.q)  # (B, M, 3, 3)
    R_w_c1 = R_c0_c1 @ R_w_c0
    t_c1_w = cams.p - (R_w_c1.transpose(-1, -2) @ t_c0_c1)  # (B, M, 3)

    d0 = pos_w[:, :, None, :] - cams.p[:, None]  # (B, K, M, 3)
    d1 = pos_w[:, :, None, :] - t_c1_w[:, None]
    p_c0 = torch.einsum("zmij,zkmj->zkmi", R_w_c0, d0)
    p_c1 = torch.einsum("zmij,zkmj->zkmi", R_w_c1, d1)
    z0 = torch.where(torch.abs(p_c0[..., 2]) > 1e-9, p_c0[..., 2], 1e-9)
    z1 = torch.where(torch.abs(p_c1[..., 2]) > 1e-9, p_c1[..., 2], 1e-9)

    dz_dpc0 = torch.zeros((B, K, M, 4, 3), dtype=dtype, device=pos_w.device)
    dz_dpc0[..., 0, 0] = 1.0 / z0
    dz_dpc0[..., 1, 1] = 1.0 / z0
    dz_dpc0[..., 0, 2] = -p_c0[..., 0] / (z0 * z0)
    dz_dpc0[..., 1, 2] = -p_c0[..., 1] / (z0 * z0)
    dz_dpc1 = torch.zeros((B, K, M, 4, 3), dtype=dtype, device=pos_w.device)
    dz_dpc1[..., 2, 0] = 1.0 / z1
    dz_dpc1[..., 3, 1] = 1.0 / z1
    dz_dpc1[..., 2, 2] = -p_c1[..., 0] / (z1 * z1)
    dz_dpc1[..., 3, 2] = -p_c1[..., 1] / (z1 * z1)

    sk0 = skew(p_c0)  # (B, K, M, 3, 3)
    dpc0_dxc = torch.cat([sk0, (-R_w_c0)[:, None].expand(B, K, M, 3, 3)], dim=-1)
    dpc1_dxc = torch.cat([R_c0_c1 @ sk0, (-R_w_c1)[:, None].expand(B, K, M, 3, 3)], dim=-1)
    H_x = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc  # (B, K, M, 4, 6)

    # Observability constraint: project out u (gravity rotation + position).
    g = gravity[:, None, :, None]
    u = torch.cat(
        [
            (jpl_to_rot(cams.q_null) @ g)[..., 0][:, None].expand(B, K, M, 3),
            (skew(pos_w[:, :, None, :] - cams.p_null[:, None]) @ g[:, None])[..., 0],
        ],
        dim=-1,
    )  # (B, K, M, 6)
    Hu = (H_x @ u[..., None])[..., 0]  # (B, K, M, 4)
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


def _cam_selector(M: int, D: int, dtype, device) -> torch.Tensor:
    """Constant (M, 6, D) one-hot placing each camera's 6-dof block, built
    by a comparison where it is used: a copy or a scalar write from the
    host would synchronise."""
    col = 21 + 6 * torch.arange(M, device=device)[:, None] + torch.arange(6, device=device)
    return (torch.arange(D, device=device) == col[..., None]).to(dtype)


def _left_nullspace_apply(F: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Q^T X for the complete QR F = Q R of each (n, k) matrix of ``F``
    (..., n, k), X (..., n, c): rows k: of the result are A^T X with A =
    Q[:, k:] the left-nullspace basis of F.

    Q is built from LAPACK's Householder reflectors (``dgeqr2``/``dlarfg``):
    H_j = I - tau_j v_j v_j^T with v_j[j] = 1, beta = -sign(alpha) |x|, and
    tau_j = 0 where the column below the diagonal is zero.  So the basis is
    the one ``jnp.linalg.qr(mode='complete')`` returns on the CPU, and no
    library QR runs: three reflections of batched tensor ops."""
    n, k = F.shape[-2:]
    rows = torch.arange(n, device=F.device)
    for j in range(k):
        below = rows > j
        alpha = F[..., j, j]
        x = torch.where(below, F[..., :, j], 0.0)
        xnorm = torch.linalg.norm(x, dim=-1)
        flat = xnorm == 0
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        tau = torch.where(flat, 0.0, (beta - alpha) / torch.where(flat, 1.0, beta))
        v = x / torch.where(flat, 1.0, alpha - beta)[..., None] + (rows == j).to(F.dtype)
        tv = (tau[..., None] * v)[..., :, None]  # (..., n, 1)
        F = F - tv * (v[..., None, :] @ F)
        X = X - tv * (v[..., None, :] @ X)
    return X


def track_jacobians(
    pos_w: torch.Tensor,  # (B, K, 3)
    obs: torch.Tensor,  # (B, K, M, 4)
    obs_mask: torch.Tensor,  # (B, K, M)
    cams: CamStates,
    gravity: torch.Tensor,
    R_c0_c1: torch.Tensor,
    t_c0_c1: torch.Tensor,
) -> TrackJacobians:
    """Stacked, nullspace-projected Jacobians of every track of every lane
    (reference featureJacobian).  The last 3 of the 4M rows are zero
    padding, as in JAX."""
    B, K, M, _ = obs.shape
    dtype = pos_w.dtype
    D = 21 + 6 * M
    blocks = track_blocks(pos_w, obs, obs_mask, cams, gravity, R_c0_c1, t_c0_c1)
    E = _cam_selector(M, D, dtype, pos_w.device)
    H_stack = torch.einsum("zkmab,mbd->zkmad", blocks.H_x, E).reshape(B, K, 4 * M, D)
    X = torch.cat([H_stack, blocks.r.reshape(B, K, 4 * M, 1)], dim=-1)
    proj = _left_nullspace_apply(blocks.H_f.reshape(B, K, 4 * M, 3), X)[..., 3:, :]
    proj = torch.cat([proj, proj.new_zeros(B, K, 3, D + 1)], dim=2)
    n_rows = 4 * torch.sum(obs_mask, dim=-1) - 3  # (B, K)
    rows_valid = torch.arange(4 * M, device=obs.device) < n_rows[..., None]
    return TrackJacobians(H_o=proj[..., :D], r_o=proj[..., D], rows_valid=rows_valid)


def gating_scores(jacs: TrackJacobians, P: torch.Tensor, sigma2) -> torch.Tensor:
    """Mahalanobis gamma (B, K) per track, r^T (H P H^T + sigma2 I)^-1 r
    over the projected rows (reference gatingTest); NaN where the system
    does not factor, which fails every chi-square test."""
    HP = torch.einsum("zkrd,zde->zkre", jacs.H_o, P)
    S = HP @ jacs.H_o.transpose(-1, -2)
    R = jacs.H_o.shape[-2]
    S = S + sigma2 * torch.eye(R, dtype=P.dtype, device=P.device)
    sol = cho_solve(cholesky_nan(S), jacs.r_o[..., None])[..., 0]
    return torch.sum(jacs.r_o * sol, dim=-1)


def _info_jitter(dtype) -> float:
    """Relative Cholesky jitter of an accumulated information matrix: it
    must dominate the f32 rounding's negative eigenvalues (order
    eps_machine * |N|) or the factorization fails."""
    return 1e-10 if dtype == torch.float64 else 1e-5


def _sqrt_information(N: torch.Tensor, y: torch.Tensor):
    """(R, r) with R^T R = N + eps I and R^T r = y for each lane's
    information (N (B, n, n), y (B, n)): the jittered Cholesky
    square root."""
    n = N.shape[-1]
    trace = torch.diagonal(N, dim1=-2, dim2=-1).sum(-1)
    eps = _info_jitter(N.dtype) * (trace / n + 1.0)
    L = cholesky_nan(N + eps[..., None, None] * torch.eye(n, dtype=N.dtype, device=N.device))
    return L.transpose(-1, -2), solve_lower(L, y)


def compress_measurements(jacs: TrackJacobians, use_mask: torch.Tensor, method: str = "qr"):
    """Compress each lane's selected tracks' rows into a (D, D) square-root
    measurement (replaces the SPQR thin QR): (R_t (B, D, D), r_t (B, D))
    with R_t^T R_t = H^T H and R_t^T r_t = H^T r.

    ``'qr'`` takes both from one reduced QR of [H | r] (its first D
    reflectors are H's, so the last column's top D entries are Q1^T r):
    on the card one launch of the hand kernel ``qr_compress`` over every
    lane (``ops/linalg.py:qr_r``), on the CPU ``torch.linalg.qr``.
    ``'cholesky'`` takes them from the jittered normal equations.  R_t is
    unique up to the signs of its rows (and, where H is rank deficient, up
    to an orthogonal factor), which the EKF update does not see."""
    dtype = jacs.H_o.dtype
    B, K, R, D = jacs.H_o.shape
    m = use_mask.to(dtype)
    H = (jacs.H_o * m[..., None, None]).reshape(B, K * R, D)
    r = (jacs.r_o * m[..., None]).reshape(B, K * R)
    if method == "qr":
        Ra = qr_r(torch.cat([H, r[..., None]], dim=-1))
        return Ra[..., :D, :D], Ra[..., :D, D]
    if method == "cholesky":
        Ht = H.transpose(-1, -2)
        return _sqrt_information(Ht @ H, (Ht @ r[..., None])[..., 0])
    raise ValueError(f"unknown compression method {method!r}")


def _feature_basis(blocks: TrackBlocks) -> torch.Tensor:
    """(B, K, 4M, 3) orthonormal basis of col(H_f) per track by modified
    Gram-Schmidt over the three columns."""
    B, K, M = blocks.obs_mask.shape
    Fm = blocks.H_f.reshape(B, K, 4 * M, 3)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)

    def dot(a, b):
        return torch.sum(a * b, dim=-1, keepdim=True)

    q0 = unit(Fm[..., 0])
    q1 = unit(Fm[..., 1] - dot(q0, Fm[..., 1]) * q0)
    q2 = unit(Fm[..., 2] - dot(q0, Fm[..., 2]) * q0 - dot(q1, Fm[..., 2]) * q1)
    return torch.stack([q0, q1, q2], dim=-1)


def _projected_information(blocks: TrackBlocks, use_mask: torch.Tensor):
    """Accumulated information of the selected tracks of each lane with the
    features marginalized, over the blocks' camera slots: the Gram matrix
    of the projected rows B = (I - Q1 Q1^T) H, kept in per-camera blocks
    (PSD to rounding even in f32).  Returns (Ncc (B, 6Mc, 6Mc), ycc
    (B, 6Mc))."""
    Bl, K, Mc = blocks.obs_mask.shape
    use = use_mask.to(blocks.H_x.dtype)
    Q1 = _feature_basis(blocks).reshape(Bl, K, Mc, 4, 3)
    W = torch.einsum("zkjac,zkjab->zkjcb", Q1, blocks.H_x)  # Q1_j^T H_xj
    Bm = -torch.einsum("zkiac,zkjcb->zkijab", Q1, W)  # (B, K, Mc, Mc, 4, 6)
    ar = torch.arange(Mc, device=Bm.device)
    Bm[:, :, ar, ar] += blocks.H_x
    rho = torch.einsum("zkiac,zkia->zkc", Q1, blocks.r)
    r_proj = blocks.r - torch.einsum("zkiac,zkc->zkia", Q1, rho)
    Ncc = torch.einsum("zk,zkijab,zkiJaB->zjbJB", use, Bm, Bm).reshape(Bl, 6 * Mc, 6 * Mc)
    ycc = torch.einsum("zk,zkijab,zkia->zjb", use, Bm, r_proj).reshape(Bl, 6 * Mc)
    return Ncc, ycc


def schur_information_cam(blocks: TrackBlocks, use_mask: torch.Tensor):
    """Camera-block information (Ncc (B, 6M, 6M), ycc (B, 6M))."""
    return _projected_information(blocks, use_mask)


def _cam_blocks(P: torch.Tensor) -> torch.Tensor:
    """(B, M, M, 6, 6) camera-camera covariance blocks of P (B, D, D)."""
    B, D = P.shape[0], P.shape[-1]
    M = (D - 21) // 6
    return P[:, 21:, 21:].reshape(B, M, 6, M, 6).permute(0, 1, 3, 2, 4)


def cam_cov_blocks(P: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
    """(B, Mc, Mc, 6, 6) camera-camera covariance blocks of each lane's
    ``cam_idx`` (B, Mc)."""
    lanes = torch.arange(P.shape[0], device=P.device)[:, None, None]
    return _cam_blocks(P)[lanes, cam_idx[:, :, None], cam_idx[:, None, :]]


def _constrained_gamma(Mk, Q1, r, sigma2, ns_iters: int):
    """gamma = r^T w with M w + Q1 lam = r, Q1^T w = 0, by block
    elimination: two solves with M, by the Newton-Schulz inverse
    (``ns_iters > 0``) or an exact Cholesky (0; NaN where M does not
    factor)."""
    if ns_iters:
        X = ns_posdef_inverse(Mk, sigma2, ns_iters)
        Minv_r = torch.einsum("...rs,...s->...r", X, r)
        Minv_Q = X @ Q1
    else:
        cho = cholesky_nan(Mk)
        Minv_r = cho_solve(cho, r[..., None])[..., 0]
        Minv_Q = cho_solve(cho, Q1)
    QMQ = torch.einsum("...ra,...rb->...ab", Q1, Minv_Q)
    QMr = torch.einsum("...ra,...r->...a", Q1, Minv_r)
    eye3 = torch.eye(3, dtype=Mk.dtype, device=Mk.device)
    lam = torch.einsum("...ab,...b->...a", inv3x3(QMQ + 1e-12 * eye3), QMr)
    w = Minv_r - torch.einsum("...ra,...a->...r", Minv_Q, lam)
    return torch.einsum("...r,...r->...", r, w)


def _gamma(blocks: TrackBlocks, Pc: torch.Tensor, sigma2, ns_iters: int) -> torch.Tensor:
    B, K, Mc = blocks.obs_mask.shape
    R4 = 4 * Mc
    MP = torch.einsum("zkiab,zijbc,zkjdc->zkijad", blocks.H_x, Pc, blocks.H_x)
    Mk = MP.permute(0, 1, 2, 4, 3, 5).reshape(B, K, R4, R4)
    Mk = Mk + sigma2 * torch.eye(R4, dtype=Mk.dtype, device=Mk.device)
    Q1 = _feature_basis(blocks)
    return _constrained_gamma(Mk, Q1, blocks.r.reshape(B, K, R4), sigma2, ns_iters)


def schur_gating(blocks: TrackBlocks, P: torch.Tensor, sigma2, ns_iters: int = 0) -> torch.Tensor:
    """Mahalanobis gamma (B, K) per track of the nullspace-projected
    system."""
    return _gamma(blocks, _cam_blocks(P), sigma2, ns_iters)


def schur_gating_compact(blocks: TrackBlocks, Pc: torch.Tensor, sigma2, ns_iters: int = 0):
    """``schur_gating`` on camera-compacted blocks with their (B, Mc, Mc, 6,
    6) covariance blocks ``Pc``."""
    return _gamma(blocks, Pc, sigma2, ns_iters)


def _ns_update(state: FilterState, Ncc, ycc, P_cols, P_cc, sigma2, ns_iters: int) -> FilterState:
    """Factorization-free information-form EKF update of each lane:
    Gcc = (s2 I + Ncc Pcc)^-1 Ncc, delta = P[:, c] (s2 I + Ncc Pcc)^-1 ycc,
    P' = P - P[:, c] Gcc P[c, :]."""
    Rk = Ncc.shape[-1]
    Mu = sigma2 * torch.eye(Rk, dtype=Ncc.dtype, device=Ncc.device) + Ncc @ P_cc
    W = ns_posdef_inverse(Mu, sigma2, ns_iters)
    Gcc = W @ Ncc
    Gcc = 0.5 * (Gcc + Gcc.transpose(-1, -2))
    delta = (P_cols @ (W @ ycc[..., None]))[..., 0]
    P_new = state.P - P_cols @ Gcc @ P_cols.transpose(-1, -2)
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    state = apply_correction(state, delta)
    return state._replace(P=P_new)


def _sqrt_update(state: FilterState, R, r, P_cols, P_cc, sigma2) -> FilterState:
    """EKF update of each lane from a square-root measurement (R (B, n, n),
    r (B, n)) on the state columns ``P_cols`` = P[:, c] (B, D, n), P_cc =
    P[c, c]: K = P[:, c] R^T S^-1 with S = R P_cc R^T + s2 I, P' = P -
    K R P[c, :] (reference measurementUpdate).  A zero R is a no-op."""
    n = R.shape[-1]
    S = R @ P_cc @ R.transpose(-1, -2) + sigma2 * torch.eye(n, dtype=R.dtype, device=R.device)
    RPt = R @ P_cols.transpose(-1, -2)  # (B, n, D)
    K = solve_nan(S, RPt).transpose(-1, -2)  # (B, D, n)
    delta = (K @ r[..., None])[..., 0]
    P_new = state.P - K @ RPt
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    state = apply_correction(state, delta)
    return state._replace(P=P_new)


def schur_information(blocks: TrackBlocks, use_mask: torch.Tensor, D: int):
    """Full-width scatter (N (B, D, D), y (B, D)) of
    ``schur_information_cam``."""
    Ncc, ycc = schur_information_cam(blocks, use_mask)
    B = Ncc.shape[0]
    N = Ncc.new_zeros(B, D, D)
    N[:, 21:, 21:] = Ncc
    y = ycc.new_zeros(B, D)
    y[:, 21:] = ycc
    return N, y


def measurement_update_schur(
    state: FilterState, blocks: TrackBlocks, use_mask: torch.Tensor, sigma2, ns_iters: int = 0
) -> FilterState:
    """EKF update from the accumulated Schur information over all camera
    slots: the information form with one Newton-Schulz inverse
    (``ns_iters > 0``), or the exact square-root update of the full-width
    information (0), equivalent to ``measurement_update(method='cholesky')``."""
    P = state.P
    if ns_iters:
        Ncc, ycc = schur_information_cam(blocks, use_mask)
        return _ns_update(state, Ncc, ycc, P[:, :, 21:], P[:, 21:, 21:], sigma2, ns_iters)
    R_t, r_t = _sqrt_information(*schur_information(blocks, use_mask, P.shape[-1]))
    return _sqrt_update(state, R_t, r_t, P, P, sigma2)


def measurement_update_schur_compact(
    state: FilterState,
    blocks: TrackBlocks,
    use_mask: torch.Tensor,
    sigma2,
    cam_idx: torch.Tensor,
    ns_iters: int = 0,
) -> FilterState:
    """Camera-compacted Schur update: the information lives in the 6*Mc
    state columns of each lane's ``cam_idx`` (B, Mc), so the update has
    rank <= 6*Mc (a Newton-Schulz inverse, or an exact (6Mc, 6Mc)
    Cholesky and solve when ``ns_iters == 0``)."""
    B, Mc = cam_idx.shape
    D = state.P.shape[-1]
    Ncc, ycc = _projected_information(blocks, use_mask)
    cols = (21 + 6 * cam_idx[..., None] + torch.arange(6, device=cam_idx.device)).reshape(B, 6 * Mc)
    P_cols = torch.gather(state.P, 2, cols[:, None, :].expand(B, D, 6 * Mc))
    P_cc = torch.gather(P_cols, 1, cols[:, :, None].expand(B, 6 * Mc, 6 * Mc))
    if ns_iters:
        return _ns_update(state, Ncc, ycc, P_cols, P_cc, sigma2, ns_iters)
    R_c, r_c = _sqrt_information(Ncc, ycc)
    return _sqrt_update(state, R_c, r_c, P_cols, P_cc, sigma2)


def measurement_update(
    state: FilterState, jacs: TrackJacobians, use_mask: torch.Tensor, sigma2, method: str = "qr"
) -> FilterState:
    """Compressed EKF update of each lane (reference measurementUpdate).  A
    lane with no selected track is left unchanged by ``'qr'`` (R_t = 0)."""
    with span("filter.compress"):
        R_t, r_t = compress_measurements(jacs, use_mask, method=method)
    return _sqrt_update(state, R_t, r_t, state.P, state.P, sigma2)


def apply_correction(state: FilterState, delta: torch.Tensor) -> FilterState:
    """Inject each lane's error-state correction (B, D) into its nominal
    state."""
    imu = state.imu
    B, M = state.cams.sid.shape
    dq_imu = small_angle_quaternion(delta[:, 0:3])
    dq_ext = small_angle_quaternion(delta[:, 15:18])
    new_imu = imu._replace(
        q=quat_multiply(dq_imu, imu.q),
        bg=imu.bg + delta[:, 3:6],
        v=imu.v + delta[:, 6:9],
        ba=imu.ba + delta[:, 9:12],
        p=imu.p + delta[:, 12:15],
        R_imu_cam0=jpl_to_rot(dq_ext) @ imu.R_imu_cam0,
        t_cam0_imu=imu.t_cam0_imu + delta[:, 18:21],
    )
    cam_delta = delta[:, 21:].reshape(B, M, 6)
    active = (torch.arange(M, device=delta.device)[None, :] < state.num_cams[:, None])[..., None]
    q_new = quat_multiply(small_angle_quaternion(cam_delta[..., 0:3]), state.cams.q)
    p_new = state.cams.p + cam_delta[..., 3:6]
    cams = state.cams._replace(
        q=torch.where(active, q_new, state.cams.q),
        p=torch.where(active, p_new, state.cams.p),
    )
    return state._replace(imu=new_imu, cams=cams)
