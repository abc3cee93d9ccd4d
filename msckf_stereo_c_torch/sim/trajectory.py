"""Synthetic VIO world: analytic trajectory, IMU synthesis, landmark
projection, and frontend-like feature tracks.

There is no synthetic-data facility in the reference (its only test is the
EuRoC golden-trajectory run, SURVEY.md §4); this module provides the oracle
needed to validate the filter numerics in isolation from the vision stack
and to benchmark on hardware without dataset files.

Everything is NumPy (host-side, data-generation only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import StereoCalib, EUROC_CALIB

GRAVITY = 9.81


@dataclasses.dataclass
class SimTrajectory:
    """Dense ground-truth trajectory sampled at IMU rate."""

    t: np.ndarray  # (N,)
    p: np.ndarray  # (N, 3) body position in world
    v: np.ndarray  # (N, 3)
    R_w_b: np.ndarray  # (N, 3, 3) world->body rotation
    gyro: np.ndarray  # (N, 3) true body angular rate
    acc: np.ndarray  # (N, 3) true specific force in body frame


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])


def make_circle_trajectory(
    duration: float = 20.0,
    imu_rate: float = 200.0,
    radius: float = 3.0,
    omega: float = 2.0 * np.pi / 20.0,
    z_amp: float = 0.5,
    roll_amp: float = 0.1,
    t_static: float = 1.5,
    t_ramp: float = 2.0,
) -> SimTrajectory:
    """Circular trajectory with sinusoidal altitude and gentle roll; the body
    yaw follows the tangent.  Starts at rest for ``t_static`` seconds (so the
    filter's gravity/bias initialization window is genuinely static), then
    spins up smoothly over ``t_ramp``.  Position/velocity/acceleration are
    analytic; the body angular rate uses a central difference at IMU rate."""
    n = int(duration * imu_rate) + 1
    t = np.arange(n) / imu_rate

    # Phase with smooth spin-up: th(u) = omega (u - T (1 - exp(-u/T))).
    u = np.maximum(t - t_static, 0.0)
    ex = np.exp(-u / t_ramp)
    th = omega * (u - t_ramp * (1.0 - ex))
    dth = np.where(t < t_static, 0.0, omega * (1.0 - ex))
    ddth = np.where(t < t_static, 0.0, omega * ex / t_ramp)

    c, s = np.cos(th), np.sin(th)
    c2, s2 = np.cos(2.0 * th), np.sin(2.0 * th)
    p = np.stack([radius * c, radius * s, z_amp * s2], axis=1)
    v = np.stack(
        [-radius * s * dth, radius * c * dth, 2.0 * z_amp * c2 * dth], axis=1
    )
    a_w = np.stack(
        [
            -radius * c * dth**2 - radius * s * ddth,
            -radius * s * dth**2 + radius * c * ddth,
            -4.0 * z_amp * s2 * dth**2 + 2.0 * z_amp * c2 * ddth,
        ],
        axis=1,
    )

    # world->body: body x = tangent, body y = world up, body z = outward
    # radial.  The EuRoC rig's cameras look along IMU ~+z, so this keeps the
    # landmark band (outer cylinder) in view.  Small roll oscillation on top.
    roll = roll_amp * np.sin(3.0 * th)
    droll = 3.0 * roll_amp * np.cos(3.0 * th) * dth
    R_w_b = _compose_rotations(roll, np.zeros(n), th)

    # Analytic body angular rate: for R_wb = Rx(roll) B(th) (each factor a
    # world->body map with generator -[e_axis]x), w_b = droll e1 + dth Rx e2
    # (B's middle row is world z, so its generator axis is body y).
    gyro = _analytic_gyro(roll, droll, np.zeros(n), np.zeros(n), th, dth)

    g_w = np.array([0.0, 0.0, -GRAVITY])
    acc = np.einsum("nij,nj->ni", R_w_b, a_w - g_w)

    return SimTrajectory(t=t, p=p, v=v, R_w_b=R_w_b, gyro=gyro, acc=acc)


def _compose_rotations(roll, pitch, psi):
    """Vectorized R_w_b(t) = Rx(roll) Ry(pitch) B(psi), where B's rows are
    [-sin, cos, 0; 0, 0, 1; cos, sin, 0] (tangent-following base: body x =
    orbit tangent, body y = world up, body z = outward radial)."""
    n = roll.shape[0]
    c, s = np.cos(psi), np.sin(psi)
    z = np.zeros(n)
    o = np.ones(n)
    base = np.stack(
        [np.stack([-s, c, z], -1), np.stack([z, z, o], -1), np.stack([c, s, z], -1)],
        axis=1,
    )
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.stack(
        [np.stack([cp, z, -sp], -1), np.stack([z, o, z], -1), np.stack([sp, z, cp], -1)],
        axis=1,
    )
    cr, sr = np.cos(roll), np.sin(roll)
    Rx = np.stack(
        [np.stack([o, z, z], -1), np.stack([z, cr, sr], -1), np.stack([z, -sr, cr], -1)],
        axis=1,
    )
    return np.einsum("nij,njk,nkl->nil", Rx, Ry, base)


def _analytic_gyro(roll, droll, pitch, dpitch, psi, dpsi):
    """Exact body angular rate of R_w_b = Rx(roll) Ry(pitch) B(psi).

    Each world->body factor A satisfies dA/dt = -thdot [e_axis]x A (axis x
    for Rx, y for both Ry and B), so stacking the chain rule:
        w_b = droll e1 + dpitch Rx e2 + dpsi Rx Ry e2.
    Verified against central differences of the rotation sequence."""
    n = roll.shape[0]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # Rx e2 = (0, cr, -sr); Rx Ry e2 = Rx (0,1,0) = same — Ry e2 = e2.
    w = np.zeros((n, 3))
    w[:, 0] = droll
    w[:, 1] = (dpitch + dpsi) * cr
    w[:, 2] = -(dpitch + dpsi) * sr
    del cp, sp
    return w


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def transform_trajectory(
    traj: SimTrajectory, yaw: float = 0.0, offset=(0.0, 0.0, 0.0)
) -> SimTrajectory:
    """Rigidly move a trajectory in the world (rotate about gravity by
    ``yaw``, then translate): a second session of the same room starting
    from a different pose.  Body-frame quantities (gyro, specific force)
    are invariant under a world yaw+translation, so the synthesized IMU
    stream is untouched — only p, v, R_w_b change."""
    W = np.array(
        [
            [np.cos(yaw), -np.sin(yaw), 0.0],
            [np.sin(yaw), np.cos(yaw), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    d = np.asarray(offset, np.float64)
    return SimTrajectory(
        t=traj.t,
        p=traj.p @ W.T + d,
        v=traj.v @ W.T,
        R_w_b=np.einsum("nij,kj->nik", traj.R_w_b, W),
        gyro=traj.gyro,
        acc=traj.acc,
    )


def make_stress_trajectory(
    duration: float = 130.0,
    imu_rate: float = 200.0,
    t_static: float = 1.5,
    t_ramp: float = 2.0,
    base_radius: float = 3.2,
    radius_amp: float = 1.2,
    omega: float = 2.0 * np.pi / 16.0,
    speed_mod: float = 0.55,
    z_amp: float = 0.8,
    roll_amp: float = 0.3,
    pitch_amp: float = 0.22,
    yaw_amp: float = 0.25,
    radius_period: float = 37.0,
    z_period: float = 11.0,
    roll_period: float = 7.3,
    pitch_period: float = 5.1,
    yaw_period: float = 9.7,
    speed_mod_period: float = 29.0,
) -> SimTrajectory:
    """The V1_01-realistic stress trajectory: long (default 130 s, vs the
    8 s bench circle), aggressive 6-dof — orbit radius breathing, strongly
    modulated angular speed (near-stalls = low-parallax stretches), fast
    altitude oscillation, and roll/pitch/yaw oscillations on top of the
    tangent-following base attitude.  Replaces nothing in the reference
    (whose only quality bar is real V1_01_easy, README.md:53-88); this is
    the harder synthetic stand-in for this environment, which has no
    dataset files.

    Every derivative here is ANALYTIC — including the orbit phase, whose
    rate integral has a closed form — so the synthesized IMU is exactly
    consistent with the position/attitude ground truth (the round-2
    central-difference version had gyro error spikes 250x the circle
    scene's, docs/STRESS_NOTES.md; dead-reckoning the noise-free IMU now
    drifts only by the filter integrator's own discretization error)."""
    n = int(duration * imu_rate) + 1
    t = np.arange(n) / imu_rate

    # Smooth spin-up phase like make_circle_trajectory.  ramp is C0 at the
    # t_static kink (its slope jumps 0 -> 1/t_ramp there — an acceleration
    # step, which an IMU represents exactly as a sample-level jump).
    u = np.maximum(t - t_static, 0.0)
    s = (t >= t_static).astype(float)  # du/dt
    ex = np.exp(-u / t_ramp)
    ramp = 1.0 - ex
    dramp = s * ex / t_ramp
    ddramp = -s * ex / t_ramp**2

    def osc(amp, period, phase=0.0):
        """amp * ramp * sin(w u + phase) with analytic d/dt and d2/dt2."""
        w = 2.0 * np.pi / period
        sn, cs = np.sin(w * u + phase), np.cos(w * u + phase)
        f = amp * ramp * sn
        df = amp * (dramp * sn + ramp * w * cs * s)
        ddf = amp * (ddramp * sn + 2.0 * dramp * w * cs - ramp * w * w * sn * s)
        return f, df, ddf

    # Angular phase with strong speed modulation (dips to ~(1-speed_mod) of
    # the base rate -> low-parallax stretches).
    #   rate(u) = omega (1 - e^{-u/T}) (1 + m sin(a u)),  a = 2 pi / 29
    # whose integral is closed-form (exponential-times-sinusoid terms).
    a29 = 2.0 * np.pi / speed_mod_period
    sn29, cs29 = np.sin(a29 * u), np.cos(a29 * u)
    rate = omega * ramp * (1.0 + speed_mod * sn29)
    drate = omega * (dramp * (1.0 + speed_mod * sn29) + ramp * speed_mod * a29 * cs29 * s)
    b = -1.0 / t_ramp
    # I(u) = int_0^u e^{bx} sin(a x) dx = [e^{bx}(b sin - a cos)]/(a^2+b^2) + a/(a^2+b^2)
    I = (ex * (b * sn29 - a29 * cs29) + a29) / (a29 * a29 + b * b)
    th = omega * (
        u
        + speed_mod * (1.0 - cs29) / a29
        + t_ramp * (ex - 1.0)
        - speed_mod * I
    )

    r_osc, dr_osc, ddr_osc = osc(radius_amp, radius_period)
    r_orb = base_radius + r_osc
    z, dz, ddz = osc(z_amp, z_period)
    cth, sth = np.cos(th), np.sin(th)
    p = np.stack([r_orb * cth, r_orb * sth, z], axis=1)
    v = np.stack(
        [
            dr_osc * cth - r_orb * sth * rate,
            dr_osc * sth + r_orb * cth * rate,
            dz,
        ],
        axis=1,
    )
    a_w = np.stack(
        [
            ddr_osc * cth
            - 2.0 * dr_osc * sth * rate
            - r_orb * cth * rate**2
            - r_orb * sth * drate,
            ddr_osc * sth
            + 2.0 * dr_osc * cth * rate
            - r_orb * sth * rate**2
            + r_orb * cth * drate,
            ddz,
        ],
        axis=1,
    )

    # Attitude: tangent-following base (cameras along body +z look at the
    # outer wall) with roll/pitch/yaw oscillations at incommensurate rates.
    roll, droll, _ = osc(roll_amp, roll_period)
    pitch, dpitch, _ = osc(pitch_amp, pitch_period, 0.7)
    yaw, dyaw, _ = osc(yaw_amp, yaw_period, 1.3)
    psi = th + yaw
    R_w_b = _compose_rotations(roll, pitch, psi)
    gyro = _analytic_gyro(roll, droll, pitch, dpitch, psi, rate + dyaw)

    g_w = np.array([0.0, 0.0, -GRAVITY])
    acc = np.einsum("nij,nj->ni", R_w_b, a_w - g_w)
    return SimTrajectory(t=t, p=p, v=v, R_w_b=R_w_b, gyro=gyro, acc=acc)


def make_fastmotion_trajectory(
    duration: float = 130.0,
    imu_rate: float = 200.0,
) -> SimTrajectory:
    """The second stress-trajectory FAMILY (VERDICT round 4 next #4):
    translation-dominant V1_02/V1_03-class motion — sustained ~2.5 m/s
    sweeps with strong radius breathing (the camera repeatedly closes to
    ~1.9 m of the wall at speed), fast altitude strokes, and saccade-like
    yaw/pitch oscillations (peak body rates ~1.4 rad/s) with far fewer
    near-stalls than the Vicon-room family.  Same analytic-derivative
    machinery as make_stress_trajectory — only the parameter point differs,
    so the IMU stream is exactly consistent with the ground truth."""
    return make_stress_trajectory(
        duration=duration,
        imu_rate=imu_rate,
        base_radius=3.4,
        radius_amp=1.5,
        omega=2.0 * np.pi / 12.0,
        speed_mod=0.35,
        z_amp=1.0,
        roll_amp=0.35,
        pitch_amp=0.3,
        yaw_amp=0.45,
        radius_period=23.0,
        z_period=7.0,
        roll_period=5.3,
        pitch_period=3.7,
        yaw_period=4.3,
        speed_mod_period=19.0,
    )


@dataclasses.dataclass
class SimImu:
    t: np.ndarray
    gyro: np.ndarray  # measured (noisy, biased)
    acc: np.ndarray


def synthesize_imu(
    traj: SimTrajectory,
    gyro_noise: float = 0.005,
    acc_noise: float = 0.05,
    gyro_bias: Optional[np.ndarray] = None,
    acc_bias: Optional[np.ndarray] = None,
    seed: int = 0,
) -> SimImu:
    """Corrupt the true rates with white noise + constant bias (matching the
    filter's noise model, discrete sigma = continuous / sqrt(dt))."""
    rng = np.random.default_rng(seed)
    n = traj.t.shape[0]
    dt = float(np.mean(np.diff(traj.t)))
    gb = np.zeros(3) if gyro_bias is None else gyro_bias
    ab = np.zeros(3) if acc_bias is None else acc_bias
    gyro = traj.gyro + gb + gyro_noise / np.sqrt(dt) * rng.standard_normal((n, 3))
    acc = traj.acc + ab + acc_noise / np.sqrt(dt) * rng.standard_normal((n, 3))
    return SimImu(t=traj.t.copy(), gyro=gyro, acc=acc)


def make_landmarks(
    num: int = 600,
    r_min: float = 5.0,
    r_max: float = 9.0,
    z_min: float = -3.0,
    z_max: float = 4.0,
    seed: int = 1,
) -> np.ndarray:
    """Random landmarks on a cylindrical band around the origin."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_min, r_max, num)
    a = rng.uniform(0.0, 2.0 * np.pi, num)
    z = rng.uniform(z_min, z_max, num)
    return np.stack([r * np.cos(a), r * np.sin(a), z], axis=1)


def make_wall_landmarks(
    num: int = 600,
    radius: float = 8.0,
    z_min: float = -3.0,
    z_max: float = 4.0,
    seed: int = 1,
) -> np.ndarray:
    """Landmarks exactly on the render wall (sim.render r_wall), so blob
    parallax and background parallax agree — the image-consistent variant
    used for end-to-end pipeline accuracy tests."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 2.0 * np.pi, num)
    z = rng.uniform(z_min, z_max, num)
    return np.stack([radius * np.cos(a), radius * np.sin(a), z], axis=1)


def make_room_landmarks(
    num: int = 700,
    radius: float = 7.0,
    z_cap: float = 3.5,
    wall_frac: float = 0.6,
    seed: int = 1,
) -> np.ndarray:
    """Landmarks on ALL surfaces of the render room (cylindrical wall +
    floor + ceiling disks, matching JaxRenderer(r_wall=radius, z_cap=z_cap))
    — the V1_01-realistic variant: the real Vicon room is a few meters
    across with feature-rich floor/ceiling, and the floor/ceiling points are
    what anchors vertical (z) observability.  The wall-only scene at 12 m
    measured a z-dominated drift precisely because every feature shared the
    same weak vertical geometry (docs/STRESS_NOTES.md round 3)."""
    rng = np.random.default_rng(seed)
    n_wall = int(num * wall_frac)
    n_cap = num - n_wall
    a = rng.uniform(0.0, 2.0 * np.pi, n_wall)
    z = rng.uniform(-z_cap, z_cap, n_wall)
    wall = np.stack([radius * np.cos(a), radius * np.sin(a), z], axis=1)
    # Caps: uniform over the disk, split between floor and ceiling.
    a2 = rng.uniform(0.0, 2.0 * np.pi, n_cap)
    r2 = radius * np.sqrt(rng.uniform(0.0, 1.0, n_cap))
    zc = np.where(rng.uniform(size=n_cap) < 0.5, -z_cap, z_cap)
    caps = np.stack([r2 * np.cos(a2), r2 * np.sin(a2), zc], axis=1)
    return np.concatenate([wall, caps], axis=0)


@dataclasses.dataclass
class SimFeatures:
    """Frontend-like output: per frame, fixed F feature slots."""

    t: np.ndarray  # (T,)
    fid: np.ndarray  # (T, F) int32, -1 invalid
    uv: np.ndarray  # (T, F, 4) normalized stereo observations
    valid: np.ndarray  # (T, F) bool
    frame_index: np.ndarray  # (T,) index into the IMU-rate trajectory


def project_tracks(
    traj: SimTrajectory,
    landmarks: np.ndarray,
    calib: StereoCalib = EUROC_CALIB,
    frame_stride: int = 10,
    max_features: int = 50,
    pixel_noise: float = 0.5,
    fov_limit: float = 0.85,
    min_depth: float = 0.3,
    seed: int = 2,
) -> SimFeatures:
    """Project landmarks into the stereo rig along the trajectory and emit
    persistent feature tracks the way the frontend would (keep tracked
    features while visible, refill free slots with new ones)."""
    rng = np.random.default_rng(seed)
    # Extrinsics: p_c0 = R_imu_cam0 (p_b - t_cam0_imu)? Careful:
    # T_cam_imu maps IMU points to cam0: p_c0 = R_ci p_i + t_ci.
    T_ci = calib.cam0.T_cam_imu_mat()
    R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
    T01 = calib.T_cam0_cam1_mat()
    R01, t01 = T01[:3, :3], T01[:3, 3]

    # Normalized-units pixel noise (focal-average scaling, like the
    # reference's norm_pixel_unit, image_processor.cpp:608).
    fx = calib.cam0.intrinsics[0]
    noise_n = pixel_noise / fx

    frame_ids = np.arange(0, traj.t.shape[0], frame_stride)
    T = frame_ids.shape[0]
    F = max_features
    L = landmarks.shape[0]

    fid = -np.ones((T, F), np.int32)
    uv = np.zeros((T, F, 4))
    valid = np.zeros((T, F), bool)

    slot_fid = -np.ones(F, np.int64)  # landmark index per slot
    next_unused = 0  # landmark ids handed out in order of first visibility

    for k, i in enumerate(frame_ids):
        R_wb, p_b = traj.R_w_b[i], traj.p[i]
        # world -> cam0: p_c0 = R_ci (R_wb (p_w - p_b)) + t_ci
        p_imu = np.einsum("ij,lj->li", R_wb, landmarks - p_b)
        p_c0 = p_imu @ R_ci.T + t_ci
        p_c1 = p_c0 @ R01.T + t01
        vis = (p_c0[:, 2] > min_depth) & (p_c1[:, 2] > min_depth)
        u0 = np.where(vis, p_c0[:, 0] / np.where(vis, p_c0[:, 2], 1.0), 0.0)
        v0 = np.where(vis, p_c0[:, 1] / np.where(vis, p_c0[:, 2], 1.0), 0.0)
        u1 = np.where(vis, p_c1[:, 0] / np.where(vis, p_c1[:, 2], 1.0), 0.0)
        v1 = np.where(vis, p_c1[:, 1] / np.where(vis, p_c1[:, 2], 1.0), 0.0)
        vis &= (np.abs(u0) < fov_limit) & (np.abs(v0) < fov_limit)
        vis &= (np.abs(u1) < fov_limit) & (np.abs(v1) < fov_limit)

        # Keep existing tracks while visible.
        for s in range(F):
            lm = slot_fid[s]
            if lm >= 0 and vis[lm]:
                fid[k, s] = lm
                uv[k, s] = [u0[lm], v0[lm], u1[lm], v1[lm]]
                valid[k, s] = True
            else:
                slot_fid[s] = -1

        # Refill free slots with unseen-but-visible landmarks.
        in_use = set(slot_fid[slot_fid >= 0].tolist())
        visible_ids = np.flatnonzero(vis)
        rng.shuffle(visible_ids)
        for lm in visible_ids:
            if lm in in_use:
                continue
            free = np.flatnonzero(slot_fid < 0)
            if free.size == 0:
                break
            s = free[0]
            slot_fid[s] = lm
            in_use.add(lm)
            fid[k, s] = lm
            uv[k, s] = [u0[lm], v0[lm], u1[lm], v1[lm]]
            valid[k, s] = True

    uv += noise_n * rng.standard_normal(uv.shape) * valid[..., None]

    return SimFeatures(
        t=traj.t[frame_ids], fid=fid, uv=uv, valid=valid, frame_index=frame_ids
    )
