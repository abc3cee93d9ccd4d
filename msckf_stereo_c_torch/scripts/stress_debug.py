"""Diagnose the stress-gate ATE on the port (port of
``scripts/stress_debug.py``): per-time-bucket aligned error against the
stress-event timeline, for a configurable variant matrix.

    STRESS_DURATION=36 STRESS_VARIANT=stress|nominal STRESS_METHOD=schur|qr \\
    STRESS_DTYPE=f32|f64 python -m msckf_stereo_c_torch.scripts.stress_debug

Runs one seed of the stress scene (``sim/stress.py:run_stress_gate``) on
the CUDA card (``STRESS_PLATFORM=cpu`` selects the CPU) and prints the
JAX script's lines: the run's ATE, the error-structure decomposition
(similarity scale, rigid and similarity ATE, per-axis RMSE), the yaw
residual per twelfth of the run, and the table of 24 time buckets (max
aligned error, texture scale, occluder radius, exposure gain, min tracks).

Knobs (environment), as in the JAX script: STRESS_DURATION (36),
STRESS_VARIANT, STRESS_METHOD, STRESS_DTYPE, STRESS_PRECISION (the
filter's matmul precision in float32), STRESS_KLT (``klt_impl``),
STRESS_TMPL (template carry, 1/0), STRESS_TLEVELS and STRESS_SLEVELS
(temporal and stereo LK levels), STRESS_TRAJ_KWARGS (JSON),
STRESS_EXACT_GRAVITY (1 pins the filter's gravity to the simulator's),
STRESS_GYRO_NOISE, STRESS_ACC_NOISE, STRESS_WALL, STRESS_ZCAP,
STRESS_GENERATOR (stress|fastmotion|circle) and STRESS_DUMP (an ``.npz``
of the aligned per-frame error).
"""
from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np


def main(env: Mapping[str, str] = os.environ) -> dict:
    """Run the variant ``env`` names and print its diagnosis; returns the
    numbers printed (``buckets`` holds the table's rows)."""
    import torch

    from ..config import FilterConfig, FrontendConfig, resolve_device
    from ..io.tum import associate, horn_align
    from ..sim import stress as _stress
    from ..sim.render_torch import make_stress_events
    from ..sim.trajectory import GRAVITY, make_stress_trajectory

    device = resolve_device("cpu" if env.get("STRESS_PLATFORM") == "cpu" else None)
    duration = float(env.get("STRESS_DURATION", "36"))
    variant = env.get("STRESS_VARIANT", "stress")
    method = env.get("STRESS_METHOD", "schur")
    f64 = env.get("STRESS_DTYPE", "f32") == "f64"
    mcfg = FilterConfig(
        ns_iters=0 if (f64 or method != "schur") else 10,
        matmul_precision="float32" if f64 else env.get("STRESS_PRECISION", "tensorfloat32"),
    )
    fcfg = FrontendConfig(
        klt_impl=env.get("STRESS_KLT", FrontendConfig.klt_impl),
        tmpl_carry=env.get("STRESS_TMPL", "1") == "1",
        temporal_levels=int(env.get("STRESS_TLEVELS", FrontendConfig.temporal_levels)),
        stereo_levels=int(env.get("STRESS_SLEVELS", FrontendConfig.stereo_levels)),
    )
    traj_kwargs = json.loads(env.get("STRESS_TRAJ_KWARGS", "{}"))
    gravity_init = _stress.batched_gravity_init
    if env.get("STRESS_EXACT_GRAVITY", "0") == "1":
        # Ablation: the simulator's exact gravity in place of |g| estimated
        # from the noisy static window (isolates the gravity error).
        def exact(states, gyro, acc):
            s = gravity_init(states, gyro, acc)
            g = torch.zeros_like(s.filt.gravity)
            g[..., 2] = -GRAVITY
            return s._replace(filt=s.filt._replace(gravity=g))

        _stress.batched_gravity_init = exact
    try:
        out = _stress.run_stress_gate(
            duration=duration,
            imu_gyro_noise=float(env.get("STRESS_GYRO_NOISE", "5e-4")),
            imu_acc_noise=float(env.get("STRESS_ACC_NOISE", "5e-3")),
            chunk=128,
            r_wall=float(env.get("STRESS_WALL", "7")),
            z_cap=float(env.get("STRESS_ZCAP", "3.5")),
            fcfg=fcfg,
            mcfg=mcfg,
            filter_dtype=torch.float64 if f64 else torch.float32,
            method=method,
            stress=(variant == "stress"),
            traj_kwargs=traj_kwargs,
            generator=env.get("STRESS_GENERATOR", "stress"),
            device=device,
        )
    finally:
        _stress.batched_gravity_init = gravity_init
    print(
        f"variant={variant} method={method} dtype={'f64' if f64 else 'f32'} "
        f"duration={duration} wall={env.get('STRESS_WALL', '7')} "
        f"klt={fcfg.klt_impl}/tmpl{int(fcfg.tmpl_carry)}/tl{fcfg.temporal_levels}/sl{fcfg.stereo_levels} "
        f"kwargs={traj_kwargs} ATE rmse={out.ate_rmse:.4f} mean={out.ate_mean:.4f} "
        f"max={out.ate_max:.4f} min_tracks={out.min_tracks_after_ransac}",
        flush=True,
    )

    # Aligned per-frame error (evaluate_ate's association and alignment).
    ia, ib = associate(out.result.times, out.gt_t, 0.02)
    e, g = out.result.positions[ia], out.gt_p[ib]
    R, t = horn_align(e, g)
    err = np.linalg.norm((e @ R.T + t) - g, axis=1)

    # Error structure: how much of the ATE is a global scale error
    # (disparity / depth bias), heading drift, or z?
    ec, gc = e - e.mean(0), g - g.mean(0)
    er = ec @ R.T  # rotation-aligned, centred estimate
    s_opt = float(np.sum(er * gc) / np.sum(er * er))
    err_s = np.linalg.norm(s_opt * er - gc, axis=1)
    d = er - gc
    axis_rmse = np.sqrt((d**2).mean(0))
    print(
        f"scale_opt={s_opt:.5f}  ate_rigid={np.sqrt((err**2).mean()):.4f}  "
        f"ate_similarity={np.sqrt((err_s**2).mean()):.4f}  "
        f"axis_rmse=({axis_rmse[0]:.4f},{axis_rmse[1]:.4f},{axis_rmse[2]:.4f})"
    )
    dump = env.get("STRESS_DUMP")
    if dump:
        np.savez(
            dump, t=out.result.times[ia], est=e, gt=g, R=R, toff=t,
            pos_cov=out.result.pos_cov[ia], tracks=out.result.tracking["after_ransac"][ia],
        )
    # Residual yaw between the aligned estimate and the truth per twelfth
    # (a linear trend is heading-rate drift).
    ang = np.degrees(np.arctan2(gc[:, 1], gc[:, 0]) - np.arctan2(er[:, 1], er[:, 0]))
    ang = (ang + 180.0) % 360.0 - 180.0
    Bv = max(1, len(ang) // 12)
    yaw = [float(ang[s : s + Bv].mean()) for s in range(0, len(ang), Bv)]
    print("yaw residual [deg] per bucket:", " ".join(f"{a:+.2f}" for a in yaw))

    traj = make_stress_trajectory(duration=duration)
    ev = make_stress_events(traj, np.arange(0, traj.t.shape[0], 10))
    tr = out.result.tracking["after_ransac"]
    print(" t[s]  err[m]  tex  occ  gain  tracks")
    B = max(1, len(err) // 24)
    buckets = []
    for s in range(0, len(err), B):
        sl = slice(s, min(s + B, len(err)))
        # Frames of the bucket through the association, so the event and
        # tracking columns stay aligned if associate() drops frames.
        fi = ia[sl]
        row = dict(t=float(out.result.times[fi][0]), err=float(err[sl].max()), tex=float(ev.tex_scale[fi].min()),
                   occ=float(ev.occ_radius[fi].max()), gain=float(ev.gain[fi][0]), tracks=int(tr[fi].min()))
        buckets.append(row)
        print(f"{row['t']:6.1f}  {row['err']:.4f}  {row['tex']:.2f}  {row['occ']:.2f}  {row['gain']:.2f}  "
              f"{row['tracks']}", flush=True)
    return dict(
        ate_rmse=out.ate_rmse, ate_mean=out.ate_mean, ate_max=out.ate_max,
        min_tracks=out.min_tracks_after_ransac, n_frames=out.n_frames, scale_opt=s_opt,
        ate_rigid=float(np.sqrt((err**2).mean())), ate_similarity=float(np.sqrt((err_s**2).mean())),
        axis_rmse=axis_rmse.tolist(), yaw_deg=yaw, buckets=buckets,
    )


if __name__ == "__main__":
    main()
