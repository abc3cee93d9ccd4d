# Frozen copy of msckf_stereo_c_torch/models/propagation.py at commit 50013dad8c92.
"""IMU process model: RK4 state propagation and observability-constrained
covariance propagation over a fixed per-frame IMU batch (port of
``msckf_stereo_c_tpu/models/propagation.py``).

Invalid slots have ``dt = 0``, which makes their step an exact no-op.  The
per-sample work is batched over the L slots once the quaternion prefix is
known; the two associative products (the quaternion prefix and the (Phi, Q)
composition) run as log-depth doubling passes of batched matmuls in place of
JAX's ``associative_scan``.  Every lane of a batched state propagates on
its own samples.  ``propagate_sequential`` and ``process_model_step`` are
the sample-by-sample reference (reference processModel) that the batched
form is held against; they are not on the frame path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.lanes import add_lane_axis, drop_lane_axis
from ..utils.lie import rot_from_two_vectors, skew
from ..utils.quaternion import jpl_to_rot, quat_normalize, rot_to_jpl
from .state import FilterState, ImuState


class ImuBatch(NamedTuple):
    """Fixed-size per-frame IMU slice (a leading B when batched); ``dt``
    holds host-exact deltas (< 0 = derive from the state clock), see
    ``runner.pack_imu_batches``."""

    time: torch.Tensor  # (L,)
    gyro: torch.Tensor  # (L, 3)
    acc: torch.Tensor  # (L, 3)
    valid: torch.Tensor  # (L,) bool
    dt: Optional[torch.Tensor] = None  # (L,)


def initialize_gravity_bias(gyro: torch.Tensor, acc: torch.Tensor):
    """Gravity and gyro bias from a static IMU window (..., n, 3) (reference
    initializeGravityAndBias).  Returns (q0 world->IMU JPL, bg, gravity),
    each with the window's leading axes."""
    bg = torch.mean(gyro, dim=-2)
    gravity_imu = torch.mean(acc, dim=-2)
    g = torch.linalg.norm(gravity_imu, dim=-1)
    gravity_world = torch.stack([torch.zeros_like(g), torch.zeros_like(g), -g], dim=-1)
    R = rot_from_two_vectors(gravity_imu, -gravity_world)
    return rot_to_jpl(R.transpose(-1, -2)), bg, gravity_world


def _prefix_products(M: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products P_i = M_i ... M_0 of (B, L, n, n) along the
    sample axis, by doubling."""
    P = M
    d = 1
    while d < M.shape[1]:
        P = torch.cat([P[:, :d], P[:, d:] @ P[:, :-d]], dim=1)
        d *= 2
    return P


def _compose_all(Phi: torch.Tensor, Q: torch.Tensor):
    """Total of the per-sample (Phi, Q) pairs (B, L, n, n) in sample order,
    with (Phi_b, Q_b) o (Phi_a, Q_a) = (Phi_b Phi_a, Phi_b Q_a Phi_b^T +
    Q_b), by pairwise halving."""
    while Phi.shape[1] > 1:
        if Phi.shape[1] % 2:
            eye = torch.eye(Phi.shape[-1], dtype=Phi.dtype, device=Phi.device)
            Phi = torch.cat([Phi, eye.expand(Phi.shape[0], 1, -1, -1)], dim=1)
            Q = torch.cat([Q, torch.zeros_like(Q[:, :1])], dim=1)
        Pa, Pb = Phi[:, 0::2], Phi[:, 1::2]
        Qa, Qb = Q[:, 0::2], Q[:, 1::2]
        Phi = Pb @ Pa
        Q = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
    return Phi[:, 0], Q[:, 0]


def _apply_propagation(state: FilterState, imu: ImuState, Phi_acc, Q_acc) -> FilterState:
    P = state.P
    top = Phi_acc @ P[:, :21, :]
    P = torch.cat([top, P[:, 21:, :]], dim=1)
    left = P[:, :, :21] @ Phi_acc.transpose(-1, -2)
    P = torch.cat([left, P[:, :, 21:]], dim=2)
    P = P.clone()
    P[:, :21, :21] += Q_acc
    P = 0.5 * (P + P.transpose(-1, -2))
    return state._replace(imu=imu, P=P)


def propagate(state: FilterState, batch: ImuBatch, Q_imu: torch.Tensor) -> FilterState:
    """One sequence's frame of IMU propagation: the one-lane view of
    ``batched_propagate``."""
    return drop_lane_axis(batched_propagate(add_lane_axis(state), add_lane_axis(batch), Q_imu))


def batched_propagate(state: FilterState, batch: ImuBatch, Q_imu: torch.Tensor) -> FilterState:
    """Batch IMU propagation over one frame's samples of each lane (reference
    batchImuProcessing): ``state`` with a leading lane axis B, ``batch``
    (B, L, ...); see the JAX original for the derivation of each batched
    stage."""
    dtype = state.P.dtype
    dev = state.P.device
    B, L = batch.time.shape
    t = batch.time.to(dtype)
    gyro_m = batch.gyro.to(dtype)
    acc_m = batch.acc.to(dtype)
    valid = batch.valid
    imu0 = state.imu
    gravity = state.gravity

    # 1. Per-sample dt: time advances only on accepted samples (running max).
    t_masked = torch.where(valid, t, float("-inf"))
    run_max = torch.maximum(torch.cummax(t_masked, dim=1).values, imu0.time[:, None])
    t_prev = torch.cat([imu0.time[:, None], run_max[:, :-1]], dim=1)
    if batch.dt is None:
        dt_raw = t - t_prev
    else:
        dt_raw = torch.where(batch.dt < 0, t - t_prev, batch.dt.to(dtype))
    stepped = valid & (dt_raw > 0)
    dt = torch.where(stepped, dt_raw, 0.0)

    gyro = gyro_m - imu0.bg[:, None]
    acc = acc_m - imu0.ba[:, None]

    # 2. Quaternion prefix: q_end_i = M_i ... M_0 q0.
    Omega = torch.zeros((B, L, 4, 4), dtype=dtype, device=dev)
    Omega[..., :3, :3] = -skew(gyro)
    Omega[..., :3, 3] = gyro
    Omega[..., 3, :3] = -gyro
    gn = torch.linalg.norm(gyro, dim=-1)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    big = gn > 1e-5
    safe = torch.where(big, gn, 1.0)

    def step_mat(frac):
        ang = gn * dt * frac
        c = torch.cos(ang)[..., None, None]
        m_big = c * eye4 + (torch.sin(ang) / safe)[..., None, None] * Omega
        m_small = (eye4 + (frac * dt)[..., None, None] * Omega) * c
        return torch.where(big[..., None, None], m_big, m_small)

    M_pre = _prefix_products(step_mat(0.5))
    q_end = quat_normalize(torch.einsum("blij,bj->bli", M_pre, imu0.q))
    q_start = torch.cat([imu0.q[:, None], q_end[:, :-1]], dim=1)
    q_mid = quat_normalize(torch.einsum("blij,blj->bli", step_mat(0.25), q_start))

    R_start_T = jpl_to_rot(q_start).transpose(-1, -2)
    R_mid_T = jpl_to_rot(q_mid).transpose(-1, -2)
    R_end_T = jpl_to_rot(q_end).transpose(-1, -2)

    # 3. RK4 v/p increments (independent of v_i, p_i).
    g = gravity[:, None]
    k1 = torch.einsum("blij,blj->bli", R_start_T, acc) + g
    k23 = torch.einsum("blij,blj->bli", R_mid_T, acc) + g
    k4 = torch.einsum("blij,blj->bli", R_end_T, acc) + g
    dv = (dt / 6.0)[..., None] * (k1 + 4.0 * k23 + k4)
    v_end = imu0.v[:, None] + torch.cumsum(dv, dim=1)
    v_start = torch.cat([imu0.v[:, None], v_end[:, :-1]], dim=1)
    dp = dt[..., None] * v_start + (dt * dt / 6.0)[..., None] * (k1 + 2.0 * k23)
    p_end = imu0.p[:, None] + torch.cumsum(dp, dim=1)
    p_start = torch.cat([imu0.p[:, None], p_end[:, :-1]], dim=1)

    # 4. Per-step Phi with the observability-constrained rows, and Q.
    before = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=dev), torch.cumsum(stepped.int(), 1)[:, :-1] > 0],
        dim=1,
    )
    q_null = torch.where(before[..., None], q_start, imu0.q_null[:, None])
    v_null = torch.where(before[..., None], v_start, imu0.v_null[:, None])
    p_null = torch.where(before[..., None], p_start, imu0.p_null[:, None])

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.zeros((B, L, 21, 21), dtype=dtype, device=dev)
    F[..., 0:3, 0:3] = -skew(gyro)
    F[..., 0:3, 3:6] = -eye3
    F[..., 6:9, 0:3] = -R_start_T @ skew(acc)
    F[..., 6:9, 9:12] = -R_start_T
    F[..., 12:15, 6:9] = eye3
    Fdt = F * dt[..., None, None]
    Fdt2 = Fdt @ Fdt
    Phi = torch.eye(21, dtype=dtype, device=dev) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

    gcol = gravity[:, None, :, None]
    R_kk_1 = jpl_to_rot(q_null)
    Phi[..., 0:3, 0:3] = jpl_to_rot(q_end) @ R_kk_1.transpose(-1, -2)
    u = (R_kk_1 @ gcol)[..., 0]
    s = u / torch.sum(u * u, dim=-1, keepdim=True)
    A1 = Phi[..., 6:9, 0:3]
    w1 = (skew(v_null - v_end) @ gcol)[..., 0]
    Phi[..., 6:9, 0:3] = A1 - ((A1 @ u[..., None])[..., 0] - w1)[..., :, None] * s[..., None, :]
    A2 = Phi[..., 12:15, 0:3]
    w2 = (skew(dt[..., None] * v_null + p_null - p_end) @ gcol)[..., 0]
    Phi[..., 12:15, 0:3] = A2 - ((A2 @ u[..., None])[..., 0] - w2)[..., :, None] * s[..., None, :]

    G = torch.zeros((B, L, 21, 12), dtype=dtype, device=dev)
    G[..., 0:3, 0:3] = -eye3
    G[..., 3:6, 3:6] = eye3
    G[..., 6:9, 6:9] = -R_start_T
    G[..., 9:12, 9:12] = eye3
    PhiG = Phi @ G
    Q = (PhiG @ Q_imu @ PhiG.transpose(-1, -2)) * dt[..., None, None]

    Phi = torch.where(stepped[..., None, None], Phi, torch.eye(21, dtype=dtype, device=dev))
    Q = torch.where(stepped[..., None, None], Q, 0.0)

    # 5. The per-frame total of the (Phi, Q) pairs.
    Phi_acc, Q_acc = _compose_all(Phi, Q)

    any_stepped = torch.any(stepped, dim=1)[:, None]
    imu = imu0._replace(
        q=q_end[:, -1],
        v=v_end[:, -1],
        p=p_end[:, -1],
        q_null=torch.where(any_stepped, q_end[:, -1], imu0.q_null),
        v_null=torch.where(any_stepped, v_end[:, -1], imu0.v_null),
        p_null=torch.where(any_stepped, p_end[:, -1], imu0.p_null),
        time=torch.where(any_stepped[:, 0], run_max[:, -1], imu0.time),
    )
    return _apply_propagation(state, imu, Phi_acc, Q_acc)


def _predict_new_state(imu: ImuState, dt, gyro, acc, gravity):
    """RK4 on (q, v, p) with closed-form quaternion integration of each
    lane's sample (reference predictNewState); every input has a leading
    lane axis B."""
    dtype, dev = imu.q.dtype, imu.q.device
    B = gyro.shape[0]
    gyro_norm = torch.linalg.norm(gyro, dim=-1)
    Omega = torch.zeros((B, 4, 4), dtype=dtype, device=dev)
    Omega[:, :3, :3] = -skew(gyro)
    Omega[:, :3, 3] = gyro
    Omega[:, 3, :3] = -gyro
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    big = (gyro_norm > 1e-5)[:, None, None]
    safe_norm = torch.where(gyro_norm > 1e-5, gyro_norm, 1.0)

    def dq_at(frac):
        ang = (gyro_norm * dt * frac)[:, None, None]
        m_big = torch.cos(ang) * eye4 + torch.sin(ang) / safe_norm[:, None, None] * Omega
        m_small = (eye4 + (2.0 * frac * dt * 0.5)[:, None, None] * Omega) * torch.cos(ang)
        return (torch.where(big, m_big, m_small) @ imu.q[..., None])[..., 0]

    def rot_T(q):
        return jpl_to_rot(q).transpose(-1, -2)

    def mv(R, x):
        return (R @ x[..., None])[..., 0]

    dq_dt = dq_at(0.5)
    dR_dt_T = rot_T(quat_normalize(dq_dt))
    dR_dt2_T = rot_T(quat_normalize(dq_at(0.25)))
    h = dt[:, None]
    k1_v_dot = mv(rot_T(imu.q), acc) + gravity
    k1_p_dot = imu.v
    k1_v = imu.v + k1_v_dot * h / 2
    k2_v_dot = mv(dR_dt2_T, acc) + gravity
    k2_p_dot = k1_v
    k2_v = imu.v + k2_v_dot * h / 2
    k3_v_dot = mv(dR_dt2_T, acc) + gravity
    k3_p_dot = k2_v
    k3_v = imu.v + k3_v_dot * h
    k4_v_dot = mv(dR_dt_T, acc) + gravity
    k4_p_dot = k3_v
    v_new = imu.v + h / 6 * (k1_v_dot + 2 * k2_v_dot + 2 * k3_v_dot + k4_v_dot)
    p_new = imu.p + h / 6 * (k1_p_dot + 2 * k2_p_dot + 2 * k3_p_dot + k4_p_dot)
    return quat_normalize(dq_dt), v_new, p_new


def _imu_step(imu: ImuState, t, m_gyro, m_acc, Q_imu, gravity, valid, dt_packed=None):
    """Nominal-state RK4 step and the 21x21 (Phi, Q) pair of one sample of
    each lane (leading axis B).  ``dt_packed`` holds host-exact deltas (< 0
    = derive from the state clock); without it the delta is t - state
    time.  A masked or non-increasing sample leaves everything unchanged,
    the FEJ shadows included."""
    dtype, dev = imu.q.dtype, imu.q.device
    B = t.shape[0]
    gyro = m_gyro - imu.bg
    acc = m_acc - imu.ba
    dt_raw = t - imu.time if dt_packed is None else torch.where(dt_packed < 0, t - imu.time, dt_packed)
    stepped = valid & (dt_raw > 0)
    dt = torch.where(stepped, dt_raw, 0.0)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    R_wi_T = jpl_to_rot(imu.q).transpose(-1, -2)
    F = torch.zeros((B, 21, 21), dtype=dtype, device=dev)
    F[:, 0:3, 0:3] = -skew(gyro)
    F[:, 0:3, 3:6] = -eye3
    F[:, 6:9, 0:3] = -R_wi_T @ skew(acc)
    F[:, 6:9, 9:12] = -R_wi_T
    F[:, 12:15, 6:9] = eye3
    G = torch.zeros((B, 21, 12), dtype=dtype, device=dev)
    G[:, 0:3, 0:3] = -eye3
    G[:, 3:6, 3:6] = eye3
    G[:, 6:9, 6:9] = -R_wi_T
    G[:, 9:12, 9:12] = eye3

    # 3rd-order matrix-exponential approximation of Phi.
    Fdt = F * dt[:, None, None]
    Fdt2 = Fdt @ Fdt
    Phi = torch.eye(21, dtype=dtype, device=dev) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

    q_new, v_new, p_new = _predict_new_state(imu, dt, gyro, acc, gravity)

    # Observability-constrained rows {0, 6, 12} against the FEJ shadows.
    g = gravity[..., None]
    R_kk_1 = jpl_to_rot(imu.q_null)
    Phi[:, 0:3, 0:3] = jpl_to_rot(q_new) @ R_kk_1.transpose(-1, -2)
    u = (R_kk_1 @ g)[..., 0]
    s = u / torch.sum(u * u, dim=-1, keepdim=True)
    A1 = Phi[:, 6:9, 0:3]
    w1 = (skew(imu.v_null - v_new) @ g)[..., 0]
    Phi[:, 6:9, 0:3] = A1 - ((A1 @ u[..., None])[..., 0] - w1)[..., :, None] * s[:, None, :]
    A2 = Phi[:, 12:15, 0:3]
    w2 = (skew(dt[:, None] * imu.v_null + imu.p_null - p_new) @ g)[..., 0]
    Phi[:, 12:15, 0:3] = A2 - ((A2 @ u[..., None])[..., 0] - w2)[..., :, None] * s[:, None, :]

    Q = (Phi @ G @ Q_imu @ G.transpose(-1, -2) @ Phi.transpose(-1, -2)) * dt[:, None, None]
    keep = stepped[:, None, None]
    Phi = torch.where(keep, Phi, torch.eye(21, dtype=dtype, device=dev))
    Q = torch.where(keep, Q, 0.0)
    k = stepped[:, None]
    new_imu = imu._replace(
        q=q_new, v=v_new, p=p_new,
        q_null=torch.where(k, q_new, imu.q_null),
        v_null=torch.where(k, v_new, imu.v_null),
        p_null=torch.where(k, p_new, imu.p_null),
        time=torch.where(stepped, t, imu.time),
    )
    return new_imu, Phi, Q


def process_model_step(state: FilterState, t, m_gyro, m_acc, Q_imu: torch.Tensor, valid) -> FilterState:
    """One IMU sample's propagation of one sequence (reference
    processModel): the full covariance multiplied by blockdiag(Phi, I).  A
    masked or non-increasing sample leaves the state unchanged."""
    s = add_lane_axis(state)
    dtype, dev = state.P.dtype, state.P.device

    def lane(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)[None]

    imu, Phi, Q = _imu_step(
        s.imu, lane(t), lane(m_gyro), lane(m_acc), Q_imu, s.gravity, lane(valid, torch.bool)
    )
    D = state.P.shape[-1]
    Phi_full = torch.eye(D, dtype=dtype, device=dev).expand(1, D, D).clone()
    Phi_full[:, :21, :21] = Phi
    P = Phi_full @ s.P @ Phi_full.transpose(-1, -2)
    P[:, :21, :21] += Q
    P = 0.5 * (P + P.transpose(-1, -2))
    return drop_lane_axis(s._replace(imu=imu, P=P))


def propagate_sequential(state: FilterState, batch: ImuBatch, Q_imu: torch.Tensor) -> FilterState:
    """One sequence's frame of IMU propagation, sample by sample: the
    one-lane view of ``batched_propagate_sequential``."""
    return drop_lane_axis(batched_propagate_sequential(add_lane_axis(state), add_lane_axis(batch), Q_imu))


def batched_propagate_sequential(state: FilterState, batch: ImuBatch, Q_imu: torch.Tensor) -> FilterState:
    """Batch IMU propagation of each lane as a loop over the L samples
    (reference batchImuProcessing): the per-sample (Phi, Q) pairs compose
    (Phi_acc <- Phi_i Phi_acc, Q_acc <- Phi_i Q_acc Phi_i^T + Q_i) and hit
    the full covariance once.  The reference ``batched_propagate`` is held
    against."""
    dtype, dev = state.P.dtype, state.P.device
    B, L = batch.time.shape
    t, gyro, acc = (x.to(dtype) for x in (batch.time, batch.gyro, batch.acc))
    dt = None if batch.dt is None else batch.dt.to(dtype)
    imu = state.imu
    Phi_acc = torch.eye(21, dtype=dtype, device=dev).repeat(B, 1, 1)
    Q_acc = torch.zeros((B, 21, 21), dtype=dtype, device=dev)
    for i in range(L):
        imu, Phi, Q = _imu_step(
            imu, t[:, i], gyro[:, i], acc[:, i], Q_imu, state.gravity, batch.valid[:, i],
            None if dt is None else dt[:, i],
        )
        Phi_acc = Phi @ Phi_acc
        Q_acc = Phi @ Q_acc @ Phi.transpose(-1, -2) + Q
    return _apply_propagation(state, imu, Phi_acc, Q_acc)
