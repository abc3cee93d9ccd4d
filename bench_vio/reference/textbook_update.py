# Frozen copy of msckf_stereo_c_torch/reference/textbook_update.py as first written, on top of commit 50cecfccd9fe.
"""The MSCKF's textbook measurement update, written out per lane and per
track in float64 with loops and no batching: the plain reference of the
port's ``method='qr'`` gate and update (``models/msckf.py:_gate_and_update``
with ``models/update.py:track_jacobians``, ``gating_scores``,
``compress_measurements`` and ``measurement_update``).

It follows msckf_vio (Sun et al., RA-L 2018; the MSCKF of Mourikis and
Roumeliotis, ICRA 2007), ``msckf_vio.cpp``:

- ``measurementJacobian`` (:679-756): each observation's 4x6 camera and 4x3
  feature Jacobians of the stereo reprojection, with the observability
  constraint (the camera's null-space orientation and position project
  gravity's rotation out of H_x, and H_f = -H_x[:, 3:6]), and the residual
  z - h(p);
- ``featureJacobian`` (:756-790): the observations of a track stacked, and
  projected onto the left null space of the stacked H_f;
- ``gatingTest`` (:909-930): gamma = r^T (H P H^T + s2 I)^-1 r against the
  chi-square 0.95 quantile of the caller's degrees of freedom;
- ``measurementUpdate`` (:795-904): the gated tracks' rows stacked, a thin QR
  keeping 21 + 6N rows where there are more rows than that, S = H P H^T +
  s2 I, the gain K = P H^T S^-1 by a symmetric (LDL^T) solve, the correction
  K r injected into the nominal state, and P <- (I - K H) P symmetrised.

Departures from msckf_vio, each on purpose:

- the left null space comes from a complete QR of each track's H_f (its
  last 4n - 3 columns of Q), where msckf_vio takes the same space from an
  SVD's U: the basis differs by an orthogonal factor, which changes neither
  gamma nor the update;
- the thin QR is ``torch.linalg.qr`` (Householder), where msckf_vio calls
  SPQR;
- the camera states are a lane's first ``num_cams`` slots of a fixed queue
  of M (the port's layout, oldest first): the update works on the
  21 + 6N active columns and leaves the rest of P as it was (zero);
- the tracks are the caller's (at most K a call, the port's
  ``max_update_tracks``), where msckf_vio stops stacking at 1,500 rows
  (:1002-1010);
- ``weight``, when given, scales a track's rows and residual by
  sqrt(weight), the port's SNR-adaptive observation noise (s2 / weight);
  msckf_vio has none (weight 1);
- msckf_vio's print when the correction's velocity or position step is
  large (:872-880) is left out; it changes nothing.

It imports nothing but ``torch`` and ``math``: no kernel and no module of
the port."""
from __future__ import annotations

import math

import torch

F64 = torch.float64


def skew(v):
    x, y, z = (float(c) for c in v)
    return torch.tensor([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]], dtype=F64)


def quaternion_to_rotation(q):
    """msckf_vio's quaternionToRotation: JPL [x, y, z, w] to the rotation
    (2w^2 - 1) I - 2w [q]x + 2 q q^T."""
    qv, w = q[:3], float(q[3])
    return (2.0 * w * w - 1.0) * torch.eye(3, dtype=F64) - 2.0 * w * skew(qv) + 2.0 * torch.outer(qv, qv)


def quaternion_multiplication(q1, q2):
    """msckf_vio's quaternionMultiplication (JPL), normalised."""
    x, y, z, w = (float(c) for c in q1)
    L = torch.tensor([[w, z, -y, x], [-z, w, x, y], [y, -x, w, z], [-x, -y, -z, w]], dtype=F64)
    q = L @ q2
    return q / torch.linalg.norm(q)


def small_angle_quaternion(dtheta):
    """msckf_vio's smallAngleQuaternion."""
    dq = dtheta / 2.0
    n2 = float(dq @ dq)
    if n2 <= 1.0:
        return torch.cat([dq, torch.tensor([math.sqrt(1.0 - n2)], dtype=F64)])
    return torch.cat([dq, torch.tensor([1.0], dtype=F64)]) / math.sqrt(1.0 + n2)


def measurement_jacobian(cam_q, cam_p, cam_q_null, cam_p_null, p_w, z, gravity, R_c0_c1, t_c0_c1):
    """(H_x (4, 6), H_f (4, 3), r (4,)) of one stereo observation ``z`` =
    [u0, v0, u1, v1] of the feature at ``p_w`` from one camera state."""
    R_w_c0 = quaternion_to_rotation(cam_q)
    t_c0_w = cam_p
    R_w_c1 = R_c0_c1 @ R_w_c0
    t_c1_w = t_c0_w - R_w_c1.T @ t_c0_c1
    p_c0 = R_w_c0 @ (p_w - t_c0_w)
    p_c1 = R_w_c1 @ (p_w - t_c1_w)

    dz_dpc0 = torch.zeros((4, 3), dtype=F64)
    dz_dpc0[0, 0] = 1.0 / p_c0[2]
    dz_dpc0[1, 1] = 1.0 / p_c0[2]
    dz_dpc0[0, 2] = -p_c0[0] / (p_c0[2] * p_c0[2])
    dz_dpc0[1, 2] = -p_c0[1] / (p_c0[2] * p_c0[2])
    dz_dpc1 = torch.zeros((4, 3), dtype=F64)
    dz_dpc1[2, 0] = 1.0 / p_c1[2]
    dz_dpc1[3, 1] = 1.0 / p_c1[2]
    dz_dpc1[2, 2] = -p_c1[0] / (p_c1[2] * p_c1[2])
    dz_dpc1[3, 2] = -p_c1[1] / (p_c1[2] * p_c1[2])

    dpc0_dxc = torch.cat([skew(p_c0), -R_w_c0], dim=1)
    dpc1_dxc = torch.cat([R_c0_c1 @ skew(p_c0), -R_w_c1], dim=1)
    H_x = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc

    # The observability constraint: the rows of H_x take no component
    # along u, the unobservable direction of gravity's rotation.
    u = torch.cat([quaternion_to_rotation(cam_q_null) @ gravity, skew(p_w - cam_p_null) @ gravity])
    H_x = H_x - torch.outer(H_x @ u, u) / float(u @ u)
    H_f = -H_x[:, 3:6]
    zhat = torch.stack([p_c0[0] / p_c0[2], p_c0[1] / p_c0[2], p_c1[0] / p_c1[2], p_c1[1] / p_c1[2]])
    return H_x, H_f, z - zhat


def feature_jacobian(slots, cams, p_w, obs, gravity, R_c0_c1, t_c0_c1, D):
    """(H (4n - 3, D), r (4n - 3,)) of one track observed from the camera
    ``slots``: the stacked rows projected onto the left null space of the
    stacked H_f."""
    n = len(slots)
    H_xj = torch.zeros((4 * n, D), dtype=F64)
    H_fj = torch.zeros((4 * n, 3), dtype=F64)
    r_j = torch.zeros(4 * n, dtype=F64)
    for i, s in enumerate(slots):
        H_x, H_f, r = measurement_jacobian(cams["q"][s], cams["p"][s], cams["q_null"][s], cams["p_null"][s], p_w,
                                           obs[s], gravity, R_c0_c1, t_c0_c1)
        H_xj[4 * i: 4 * i + 4, 21 + 6 * s: 27 + 6 * s] = H_x
        H_fj[4 * i: 4 * i + 4] = H_f
        r_j[4 * i: 4 * i + 4] = r
    A = torch.linalg.qr(H_fj, mode="complete").Q[:, 3:]
    return A.T @ H_xj, A.T @ r_j


def ldlt_solve(S, B):
    """S^-1 B for symmetric S, by its LDL^T factorization (Eigen's ldlt)."""
    LD, pivots = torch.linalg.ldl_factor(S)
    return torch.linalg.ldl_solve(LD, pivots, B)


def gating_test(H, r, P, sigma2):
    """gamma = r^T (H P H^T + s2 I)^-1 r."""
    S = H @ P @ H.T + sigma2 * torch.eye(H.shape[0], dtype=F64)
    return float(r @ ldlt_solve(S, r[:, None])[:, 0])


def measurement_update(P, H, r, sigma2):
    """(delta_x, P') of the stacked rows: thin QR to the columns' count
    where there are more rows, the gain by a symmetric solve, (I - K H) P
    symmetrised.  No rows leave P as it is."""
    if H.shape[0] == 0:
        return torch.zeros(P.shape[0], dtype=F64), P.clone()
    if H.shape[0] > H.shape[1]:
        Q, R = torch.linalg.qr(H)
        H_thin, r_thin = R, Q.T @ r
    else:
        H_thin, r_thin = H, r
    S = H_thin @ P @ H_thin.T + sigma2 * torch.eye(H_thin.shape[0], dtype=F64)
    K = ldlt_solve(S, H_thin @ P).T
    delta_x = K @ r_thin
    I_KH = torch.eye(P.shape[0], dtype=F64) - K @ H_thin
    P_new = I_KH @ P
    return delta_x, (P_new + P_new.T) / 2.0


def correct_state(imu, cams, delta_x, N):
    """The nominal state after the error-state correction ``delta_x``
    (21 + 6N): IMU orientation, biases, velocity, position, extrinsics,
    then each active camera's orientation and position."""
    imu = dict(imu)
    imu["q"] = quaternion_multiplication(small_angle_quaternion(delta_x[0:3]), imu["q"])
    imu["bg"] = imu["bg"] + delta_x[3:6]
    imu["v"] = imu["v"] + delta_x[6:9]
    imu["ba"] = imu["ba"] + delta_x[9:12]
    imu["p"] = imu["p"] + delta_x[12:15]
    imu["R_imu_cam0"] = quaternion_to_rotation(small_angle_quaternion(delta_x[15:18])) @ imu["R_imu_cam0"]
    imu["t_cam0_imu"] = imu["t_cam0_imu"] + delta_x[18:21]
    q, p = cams["q"].clone(), cams["p"].clone()
    for s in range(N):
        d = delta_x[21 + 6 * s: 27 + 6 * s]
        q[s] = quaternion_multiplication(small_angle_quaternion(d[:3]), q[s])
        p[s] = p[s] + d[3:]
    return imu, dict(cams, q=q, p=p)


def textbook_update(P, imu, cams, num_cams, gravity, R_c0_c1, t_c0_c1, sigma2, pos, obs, obs_mask, use,
                    chi2_threshold, weight=None):
    """Gate and update each lane of a batch with its tracks, lane by lane
    and track by track, in float64.

    P (B, D, D) with D = 21 + 6M; ``imu`` a dict of q (B, 4), bg, v, ba, p
    (B, 3), R_imu_cam0 (B, 3, 3), t_cam0_imu (B, 3); ``cams`` a dict of q,
    q_null (B, M, 4), p, p_null (B, M, 3); ``num_cams`` (B,); ``gravity``
    (B, 3); R_c0_c1 (3, 3), t_c0_c1 (3,); ``sigma2`` the observation
    noise variance; the tracks' ``pos`` (B, K, 3), ``obs`` (B, K, M, 4),
    ``obs_mask`` (B, K, M), ``use`` (B, K), their chi-square thresholds
    ``chi2_threshold`` (B, K) and optional ``weight`` (B, K).

    Returns a dict: P (B, D, D), imu, cams (as given, updated), gamma
    (B, K; NaN for a track not in ``use``) and passed (B, K)."""
    def f64(x):
        return torch.as_tensor(x).detach().to("cpu", F64)

    P = f64(P)
    B, D = P.shape[0], P.shape[-1]
    K = pos.shape[1]
    imu = {k: f64(v) for k, v in imu.items()}
    cams = {k: f64(v) for k, v in cams.items()}
    gravity, pos, obs = f64(gravity), f64(pos), f64(obs)
    R_c0_c1, t_c0_c1 = f64(R_c0_c1), f64(t_c0_c1)
    sigma2 = float(sigma2)
    obs_mask = torch.as_tensor(obs_mask).cpu().bool()
    use = torch.as_tensor(use).cpu().bool()
    chi2_threshold = f64(chi2_threshold)
    weight = None if weight is None else f64(weight)
    num_cams = torch.as_tensor(num_cams).cpu()

    P_out = P.clone()
    gamma = torch.full((B, K), float("nan"), dtype=F64)
    passed = torch.zeros((B, K), dtype=torch.bool)
    imu_out = {k: v.clone() for k, v in imu.items()}
    cams_out = {k: v.clone() for k, v in cams.items()}
    for b in range(B):
        N = int(num_cams[b])
        Da = 21 + 6 * N
        Pa = P[b, :Da, :Da]
        lane_cams = {k: v[b] for k, v in cams.items()}
        rows_H, rows_r = [], []
        for k in range(K):
            slots = [s for s in range(obs_mask.shape[2]) if bool(obs_mask[b, k, s])]
            if not bool(use[b, k]) or not slots:
                continue
            H, r = feature_jacobian(slots, lane_cams, pos[b, k], obs[b, k], gravity[b], R_c0_c1, t_c0_c1, Da)
            if weight is not None:
                sw = math.sqrt(float(weight[b, k]))
                H, r = H * sw, r * sw
            gamma[b, k] = gating_test(H, r, Pa, sigma2)
            if gamma[b, k] < chi2_threshold[b, k]:
                passed[b, k] = True
                rows_H.append(H)
                rows_r.append(r)
        if not rows_H:
            continue
        delta_x, Pa_new = measurement_update(Pa, torch.cat(rows_H), torch.cat(rows_r), sigma2)
        P_out[b, :Da, :Da] = Pa_new
        lane_imu, lane_cams_new = correct_state({k: v[b] for k, v in imu.items()}, lane_cams, delta_x, N)
        for key, value in lane_imu.items():
            imu_out[key][b] = value
        for key in ("q", "p"):
            cams_out[key][b] = lane_cams_new[key]
    return dict(P=P_out, imu=imu_out, cams=cams_out, gamma=gamma, passed=passed)
