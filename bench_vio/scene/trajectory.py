# Frozen copy of msckf_stereo_c_torch/sim/trajectory.py at commit 50013dad8c92: the stress trajectory,
# the room landmarks and the IMU synthesis, with what no cell uses left out.
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


