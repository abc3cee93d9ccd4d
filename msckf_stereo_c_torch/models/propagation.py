"""IMU process model: RK4 state propagation and observability-constrained
covariance propagation over a fixed per-frame IMU batch (port of
``msckf_stereo_c_tpu/models/propagation.py:propagate``).

Invalid slots have ``dt = 0``, which makes their step an exact no-op.  The
per-sample work is batched over the L slots once the quaternion prefix is
known; the two associative products (the quaternion prefix and the (Phi, Q)
composition) run as log-depth doubling passes of batched matmuls in place of
JAX's ``associative_scan``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.lie import rot_from_two_vectors, skew
from ..utils.quaternion import jpl_to_rot, quat_normalize, rot_to_jpl
from .state import FilterState, ImuState


class ImuBatch(NamedTuple):
    """Fixed-size per-frame IMU slice; ``dt`` holds host-exact deltas
    (< 0 = derive from the state clock), see ``runner.pack_imu_batches``."""

    time: torch.Tensor  # (L,)
    gyro: torch.Tensor  # (L, 3)
    acc: torch.Tensor  # (L, 3)
    valid: torch.Tensor  # (L,) bool
    dt: Optional[torch.Tensor] = None  # (L,)


def initialize_gravity_bias(gyro: torch.Tensor, acc: torch.Tensor):
    """Gravity and gyro bias from a static IMU window (reference
    initializeGravityAndBias).  Returns (q0 world->IMU JPL, bg, gravity)."""
    bg = torch.mean(gyro, dim=0)
    gravity_imu = torch.mean(acc, dim=0)
    g = torch.linalg.norm(gravity_imu)
    gravity_world = torch.stack([torch.zeros_like(g), torch.zeros_like(g), -g])
    R = rot_from_two_vectors(gravity_imu, -gravity_world)
    return rot_to_jpl(R.T), bg, gravity_world


def _prefix_products(M: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products P_i = M_i ... M_0 of (L, n, n) by doubling."""
    P = M
    d = 1
    while d < M.shape[0]:
        P = torch.cat([P[:d], P[d:] @ P[:-d]], dim=0)
        d *= 2
    return P


def _compose_all(Phi: torch.Tensor, Q: torch.Tensor):
    """Total of the per-sample (Phi, Q) pairs in sample order, with
    (Phi_b, Q_b) o (Phi_a, Q_a) = (Phi_b Phi_a, Phi_b Q_a Phi_b^T + Q_b),
    by pairwise halving."""
    while Phi.shape[0] > 1:
        if Phi.shape[0] % 2:
            eye = torch.eye(Phi.shape[-1], dtype=Phi.dtype, device=Phi.device)[None]
            Phi = torch.cat([Phi, eye], dim=0)
            Q = torch.cat([Q, torch.zeros_like(Q[:1])], dim=0)
        Pa, Pb = Phi[0::2], Phi[1::2]
        Qa, Qb = Q[0::2], Q[1::2]
        Phi = Pb @ Pa
        Q = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
    return Phi[0], Q[0]


def _apply_propagation(state: FilterState, imu: ImuState, Phi_acc, Q_acc) -> FilterState:
    P = state.P
    top = Phi_acc @ P[:21, :]
    P = torch.cat([top, P[21:, :]], dim=0)
    left = P[:, :21] @ Phi_acc.T
    P = torch.cat([left, P[:, 21:]], dim=1)
    P = P.clone()
    P[:21, :21] += Q_acc
    P = 0.5 * (P + P.T)
    return state._replace(imu=imu, P=P)


def propagate(state: FilterState, batch: ImuBatch, Q_imu: torch.Tensor) -> FilterState:
    """Batch IMU propagation over one frame's samples (reference
    batchImuProcessing); see the JAX original for the derivation of each
    batched stage."""
    dtype = state.P.dtype
    dev = state.P.device
    L = batch.time.shape[0]
    t = batch.time.to(dtype)
    gyro_m = batch.gyro.to(dtype)
    acc_m = batch.acc.to(dtype)
    valid = batch.valid
    imu0 = state.imu
    gravity = state.gravity

    # 1. Per-sample dt: time advances only on accepted samples (running max).
    t_masked = torch.where(valid, t, float("-inf"))
    run_max = torch.maximum(torch.cummax(t_masked, dim=0).values, imu0.time)
    t_prev = torch.cat([imu0.time[None], run_max[:-1]])
    if batch.dt is None:
        dt_raw = t - t_prev
    else:
        dt_raw = torch.where(batch.dt < 0, t - t_prev, batch.dt.to(dtype))
    stepped = valid & (dt_raw > 0)
    dt = torch.where(stepped, dt_raw, 0.0)

    gyro = gyro_m - imu0.bg
    acc = acc_m - imu0.ba

    # 2. Quaternion prefix: q_end_i = M_i ... M_0 q0.
    Omega = torch.zeros((L, 4, 4), dtype=dtype, device=dev)
    Omega[:, :3, :3] = -skew(gyro)
    Omega[:, :3, 3] = gyro
    Omega[:, 3, :3] = -gyro
    gn = torch.linalg.norm(gyro, dim=-1)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    big = gn > 1e-5
    safe = torch.where(big, gn, 1.0)

    def step_mat(frac):
        ang = gn * dt * frac
        c = torch.cos(ang)[:, None, None]
        m_big = c * eye4 + (torch.sin(ang) / safe)[:, None, None] * Omega
        m_small = (eye4 + (frac * dt)[:, None, None] * Omega) * c
        return torch.where(big[:, None, None], m_big, m_small)

    M_pre = _prefix_products(step_mat(0.5))
    q_end = quat_normalize(torch.einsum("lij,j->li", M_pre, imu0.q))
    q_start = torch.cat([imu0.q[None], q_end[:-1]], dim=0)
    q_mid = quat_normalize(torch.einsum("lij,lj->li", step_mat(0.25), q_start))

    R_start_T = jpl_to_rot(q_start).transpose(-1, -2)
    R_mid_T = jpl_to_rot(q_mid).transpose(-1, -2)
    R_end_T = jpl_to_rot(q_end).transpose(-1, -2)

    # 3. RK4 v/p increments (independent of v_i, p_i).
    k1 = torch.einsum("lij,lj->li", R_start_T, acc) + gravity
    k23 = torch.einsum("lij,lj->li", R_mid_T, acc) + gravity
    k4 = torch.einsum("lij,lj->li", R_end_T, acc) + gravity
    dv = (dt / 6.0)[:, None] * (k1 + 4.0 * k23 + k4)
    v_end = imu0.v + torch.cumsum(dv, dim=0)
    v_start = torch.cat([imu0.v[None], v_end[:-1]], dim=0)
    dp = dt[:, None] * v_start + (dt * dt / 6.0)[:, None] * (k1 + 2.0 * k23)
    p_end = imu0.p + torch.cumsum(dp, dim=0)
    p_start = torch.cat([imu0.p[None], p_end[:-1]], dim=0)

    # 4. Per-step Phi with the observability-constrained rows, and Q.
    before = torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=dev), torch.cumsum(stepped.int(), 0)[:-1] > 0]
    )
    q_null = torch.where(before[:, None], q_start, imu0.q_null)
    v_null = torch.where(before[:, None], v_start, imu0.v_null)
    p_null = torch.where(before[:, None], p_start, imu0.p_null)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.zeros((L, 21, 21), dtype=dtype, device=dev)
    F[:, 0:3, 0:3] = -skew(gyro)
    F[:, 0:3, 3:6] = -eye3
    F[:, 6:9, 0:3] = -R_start_T @ skew(acc)
    F[:, 6:9, 9:12] = -R_start_T
    F[:, 12:15, 6:9] = eye3
    Fdt = F * dt[:, None, None]
    Fdt2 = Fdt @ Fdt
    Phi = torch.eye(21, dtype=dtype, device=dev) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

    R_kk_1 = jpl_to_rot(q_null)
    Phi[:, 0:3, 0:3] = jpl_to_rot(q_end) @ R_kk_1.transpose(-1, -2)
    u = R_kk_1 @ gravity
    s = u / torch.sum(u * u, dim=-1, keepdim=True)
    A1 = Phi[:, 6:9, 0:3]
    w1 = skew(v_null - v_end) @ gravity
    Phi[:, 6:9, 0:3] = A1 - ((A1 @ u[..., None])[..., 0] - w1)[:, :, None] * s[:, None, :]
    A2 = Phi[:, 12:15, 0:3]
    w2 = skew(dt[:, None] * v_null + p_null - p_end) @ gravity
    Phi[:, 12:15, 0:3] = A2 - ((A2 @ u[..., None])[..., 0] - w2)[:, :, None] * s[:, None, :]

    G = torch.zeros((L, 21, 12), dtype=dtype, device=dev)
    G[:, 0:3, 0:3] = -eye3
    G[:, 3:6, 3:6] = eye3
    G[:, 6:9, 6:9] = -R_start_T
    G[:, 9:12, 9:12] = eye3
    PhiG = Phi @ G
    Q = (PhiG @ Q_imu @ PhiG.transpose(-1, -2)) * dt[:, None, None]

    Phi = torch.where(stepped[:, None, None], Phi, torch.eye(21, dtype=dtype, device=dev))
    Q = torch.where(stepped[:, None, None], Q, 0.0)

    # 5. The per-frame total of the (Phi, Q) pairs.
    Phi_acc, Q_acc = _compose_all(Phi, Q)

    any_stepped = torch.any(stepped)
    imu = imu0._replace(
        q=q_end[-1],
        v=v_end[-1],
        p=p_end[-1],
        q_null=torch.where(any_stepped, q_end[-1], imu0.q_null),
        v_null=torch.where(any_stepped, v_end[-1], imu0.v_null),
        p_null=torch.where(any_stepped, p_end[-1], imu0.p_null),
        time=torch.where(any_stepped, run_max[-1], imu0.time),
    )
    return _apply_propagation(state, imu, Phi_acc, Q_acc)
