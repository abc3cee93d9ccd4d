"""Front-end-only track-accuracy probe (port of ``scripts/track_bias_probe.py``):
run the tracker alone (no filter) over a rendered sequence and compare the
blob-landmark tracks with their ground-truth projections, which isolates
the tracker's systematic error from the filter's.

    PROBE_DUR=36 PROBE_WALL=8 PROBE_KLT=corr PROBE_TMPL=1 python -m msckf_stereo_c_torch.scripts.track_bias_probe

The tracker is ``models/frontend.py:frontend_step`` (the one-lane view of
``batched_frontend_step``) frame by frame over ``sim/render_torch.py``
renders, fed the ground-truth camera velocity at the previous frame
(``PROBE_VEL=1``, as ``run_vio_sequence`` feeds it the filter's estimate) or none
(rotation-only prediction).  The association of tracks with landmarks, the
bias tables (by track age, by image row, age x row, by time) and the
bad-lock counts are numpy on the host (``bias_tables``); the lines printed
are the JAX script's, in its format.

Knobs (environment), as in the JAX script: PROBE_DUR (36 s), PROBE_WALL
(8 m), PROBE_KLT (``klt_impl``), PROBE_TMPL (template carry, 1/0),
PROBE_TLEVELS and PROBE_SLEVELS (temporal and stereo LK levels),
PROBE_ANCHOR (anchor refine, 1/0), PROBE_GENERATOR (circle|stress), for
the circle PROBE_ZAMP, PROBE_ROLLAMP and PROBE_OMEGA, PROBE_VEL, PROBE_TEX
(texture scale), PROBE_NOISE (1: the stress gate's sensor noise),
PROBE_VIG (vignette fraction) and PROBE_BLUR (1: motion blur).  Runs on the
CUDA card; ``PROBE_PLATFORM=cpu`` selects the CPU (the JAX script's default
is the CPU).
"""
from __future__ import annotations

import inspect
import os
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..config import EUROC_CALIB, FrontendConfig, StereoCalib, resolve_device

CHUNK = 64  # frames rendered and tracked per chunk
AGE_BINS = ((0, 1), (1, 3), (3, 6), (6, 10), (10, 15), (15, 25), (25, 60))
JOINT_AGE_BINS = ((0, 2), (2, 6), (6, 15), (15, 60))
JOINT_V_BINS = ((-1.0, -0.3), (-0.3, 0.0), (0.0, 0.3), (0.3, 1.0))


class Knobs(NamedTuple):
    duration: float
    r_wall: float
    fcfg: FrontendConfig
    generator: str
    circle_kwargs: dict
    use_vel: bool
    tex_scale: float
    noise: bool
    vignette: float
    blur: bool
    device: torch.device


def probe_knobs(env: Mapping[str, str] = os.environ) -> Knobs:
    """The JAX script's ``PROBE_*`` knobs with its defaults; the device is
    the card unless ``PROBE_PLATFORM=cpu`` (raises without a card)."""
    fcfg = FrontendConfig(
        klt_impl=env.get("PROBE_KLT", FrontendConfig.klt_impl),
        tmpl_carry=env.get("PROBE_TMPL", "1") == "1",
        temporal_levels=int(env.get("PROBE_TLEVELS", FrontendConfig.temporal_levels)),
        stereo_levels=int(env.get("PROBE_SLEVELS", FrontendConfig.stereo_levels)),
        anchor_refine=env.get("PROBE_ANCHOR", "1") == "1",
    )
    return Knobs(
        duration=float(env.get("PROBE_DUR", "36")),
        r_wall=float(env.get("PROBE_WALL", "8")),
        fcfg=fcfg,
        generator="stress" if env.get("PROBE_GENERATOR", "circle") == "stress" else "circle",
        circle_kwargs=dict(
            z_amp=float(env.get("PROBE_ZAMP", "0.5")),
            roll_amp=float(env.get("PROBE_ROLLAMP", "0.1")),
            omega=float(env.get("PROBE_OMEGA", str(2.0 * 3.14159265 / 20.0))),
        ),
        use_vel=env.get("PROBE_VEL", "1") == "1",
        tex_scale=float(env.get("PROBE_TEX", "1")),
        noise=env.get("PROBE_NOISE", "0") == "1",
        vignette=float(env.get("PROBE_VIG", "0")),
        blur=env.get("PROBE_BLUR", "0") == "1",
        device=resolve_device("cpu" if env.get("PROBE_PLATFORM") == "cpu" else None),
    )


def chunk_events(knobs: Knobs, s0: int, s1: int):
    """The photometric channels of frames [s0, s1), frame-aligned with the
    absolute index (the noise is the gate's draw at seed 0)."""
    from ..sim.render_torch import StressEvents, make_stress_events

    n = s1 - s0
    ev = StressEvents.nominal(n)
    ev.tex_scale[:] = knobs.tex_scale
    if knobs.noise:
        # The gate's noise spec: make_stress_events' defaults.
        defaults = inspect.signature(make_stress_events).parameters
        ev.noise_read = np.full(n, defaults["noise_read_dn"].default)
        ev.noise_shot = np.full(n, defaults["noise_shot_gain"].default)
        ev.noise_frame0 = s0
    if knobs.vignette > 0:
        ev.vignette = np.full(n, knobs.vignette)
    if knobs.blur:
        ev.blur = np.ones(n)
    return ev


def run_tracker(knobs: Knobs, traj, idx: np.ndarray, landmarks: np.ndarray, imu, calib: StereoCalib = EUROC_CALIB):
    """The tracker alone over the frames ``idx`` of ``traj``: returns numpy
    (fid (T, N), uv (T, N, 4), valid (T, N)) of the published tracks."""
    from ..models.frontend import frontend_step, init_tracker_state, make_frontend_params, pyramids_for
    from ..models.runner import pack_imu_batches
    from ..sim.render_torch import TorchRenderer

    dev, f32, fcfg = knobs.device, torch.float32, knobs.fcfg
    T = len(idx)
    frame_t = traj.t[idx]
    renderer = TorchRenderer(landmarks, calib, r_wall=knobs.r_wall, device=dev)
    fparams = make_frontend_params(calib, f32, dev)
    batches = pack_imu_batches(imu.t, imu.gyro, imu.acc, frame_t, 16, np.float32)
    valid = batches.valid.numpy()
    mean_gyro = (np.where(valid[:, :, None], batches.gyro.numpy(), 0.0).sum(1)
                 / np.maximum(valid.sum(1), 1)[:, None]).astype(np.float32)
    # Ground-truth velocity at the PREVIOUS frame in cam0, where
    # run_vio_sequence feeds the filter's estimate.
    prev_i = np.maximum(idx - 10, 0)
    R_ci = calib.cam0.T_cam_imu_mat()[:3, :3]
    cam_vels = np.einsum("ij,tjk,tk->ti", R_ci, traj.R_w_b[prev_i], traj.v[prev_i]).astype(np.float32)

    H, W = calib.cam0.resolution[1], calib.cam0.resolution[0]
    tracker = init_tracker_state(fcfg, f32, dev)
    pyr_prev = pyramids_for(torch.zeros((H, W), dtype=f32, device=dev), fcfg)
    prev_t = torch.full((), -1.0, dtype=f32, device=dev)
    fids, uvs, valids = [], [], []
    for s0 in range(0, T, CHUNK):
        s1 = min(s0 + CHUNK, T)
        img0, img1 = renderer.render_sequence(traj, idx[s0:s1], chunk_events(knobs, s0, s1), chunk=CHUNK)
        ts = torch.as_tensor(frame_t[s0:s1], dtype=f32).to(dev)
        gyros = torch.as_tensor(mean_gyro[s0:s1]).to(dev)
        vels = torch.as_tensor(cam_vels[s0:s1]).to(dev)
        f_c, u_c, v_c = [], [], []
        for k in range(s1 - s0):
            pyr0 = pyramids_for(img0[k], fcfg)
            pyr1 = pyramids_for(img1[k], fcfg)
            is_first = prev_t < 0
            dt = torch.where(is_first, 0.0, ts[k] - prev_t)
            tracker, out = frontend_step(
                tracker, pyr_prev, pyr0, pyr1, gyros[k], dt, is_first, fparams, fcfg,
                cam_vel=vels[k] if knobs.use_vel else None,
            )
            pyr_prev, prev_t = pyr0, ts[k]
            f_c.append(out.fid)
            u_c.append(out.uv)
            v_c.append(out.valid)
        fids.append(torch.stack(f_c).cpu().numpy())
        uvs.append(torch.stack(u_c).cpu().numpy())
        valids.append(torch.stack(v_c).cpu().numpy())
    return np.concatenate(fids), np.concatenate(uvs), np.concatenate(valids)


def ground_truth(traj, idx: np.ndarray, landmarks: np.ndarray, calib: StereoCalib = EUROC_CALIB):
    """Normalized projections of every landmark in each frame: (n0 (T, L,
    2), z0 (T, L), n1 (T, L, 2)) for cam0 (with depth) and cam1."""
    T_ci0 = calib.cam0.T_cam_imu_mat()
    T_ci1 = calib.T_cam0_cam1_mat() @ T_ci0
    R_wb, p_b = traj.R_w_b[idx], traj.p[idx]

    def norm(T_ci):
        R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
        rel = landmarks[None, :, :] - p_b[:, None, :]
        p_imu = np.einsum("tij,tlj->tli", R_wb, rel)
        p_cam = np.einsum("ij,tlj->tli", R_ci, p_imu) + t_ci
        return p_cam[..., :2] / p_cam[..., 2:3], p_cam[..., 2]

    n0, z0 = norm(T_ci0)
    n1, _ = norm(T_ci1)
    return n0, z0, n1


def bias_tables(fid, uv, valid, n0, z0, n1, fx: float, frame_t) -> dict:
    """Associate each track with a landmark at its birth (nearest cam0
    projection within 2 px, depth > 0.3 m), then print and return the JAX
    script's tables of the tracks' error against ground truth in pixels:
    du, dv (cam0) and the disparity error, overall, by outlier size, per
    track (bad locks, born bad, lifetime), by track age, by image row
    (normalized v), age x row, and by time."""
    T = fid.shape[0]
    first_seen, assoc, res = {}, {}, {}
    for t in range(T):
        for i in np.flatnonzero(valid[t]):
            f = int(fid[t, i])
            obs = uv[t, i]
            if f not in first_seen:
                d2 = np.sum((n0[t] - obs[:2]) ** 2, axis=1)
                j = int(np.argmin(d2))
                first_seen[f] = t
                if d2[j] < (2.0 / fx) ** 2 and z0[t, j] > 0.3:
                    assoc[f] = j
            j = assoc.get(f)
            if j is None:
                continue
            du0 = (obs[0] - n0[t, j, 0]) * fx
            dv0 = (obs[1] - n0[t, j, 1]) * fx
            gt_disp = (n0[t, j, 0] - n1[t, j, 0]) * fx
            tr_disp = (obs[0] - obs[2]) * fx
            res.setdefault(f, []).append((t, du0, dv0, tr_disp - gt_disp, t - first_seen[f], n0[t, j, 1]))

    allr = np.array([r for v in res.values() for r in v])
    ad, adu = np.abs(allr[:, 3]), np.abs(allr[:, 1])
    out = dict(
        tracks_associated=len(res), tracks_seen=len(first_seen), obs=len(allr),
        du_mean=allr[:, 1].mean(), du_p50=np.percentile(adu, 50), du_p90=np.percentile(adu, 90),
        dv_mean=allr[:, 2].mean(),
        ddisp_mean=allr[:, 3].mean(), ddisp_p50=np.percentile(ad, 50), ddisp_p90=np.percentile(ad, 90),
    )
    print(f"tracks associated: {len(res)} / {len(first_seen)}; obs: {len(allr)}")
    print(f"cam0 du: mean {out['du_mean']:+.4f} px  |du| p50/p90 {out['du_p50']:.3f}/{out['du_p90']:.3f}")
    print(f"cam0 dv: mean {out['dv_mean']:+.4f} px")
    print(f"disparity err: mean {out['ddisp_mean']:+.4f} px  p50/p90 {out['ddisp_p50']:.3f}/{out['ddisp_p90']:.3f}")
    # Wrong stereo locks ride ALONG the epipolar line and pass the
    # epipolar gate: how much of the mean they carry.
    out["outliers"] = []
    for thr in (0.1, 0.5, 2.0, 5.0):
        m = ad > thr
        row = dict(thr=thr, share=m.mean(), ddisp_mean=allr[m, 3].mean() if m.any() else 0.0)
        out["outliers"].append(row)
        print(f"|ddisp|>{thr:4.1f}: {row['share'] * 100:5.2f}% of obs, mean ddisp there {row['ddisp_mean']:+.3f} px")
    # Per track: born bad vs goes bad.
    med_by_track = {f: np.median([r[3] for r in v]) for f, v in res.items()}
    bad = [f for f, m in med_by_track.items() if abs(m) > 0.5]
    born_bad = sum(1 for f in bad if abs(sorted(res[f])[0][3]) > 0.5)
    out.update(bad_tracks=len(bad), born_bad=born_bad)
    print(f"tracks with |median ddisp|>0.5: {len(bad)} / {len(res)}")
    print(f"  of which born bad (|ddisp|>0.5 at first obs): {born_bad}")
    if bad:
        lt = [len(res[f]) for f in bad]
        out.update(bad_lifetime_mean=float(np.mean(lt)), bad_lifetime_max=int(np.max(lt)))
        print(f"  bad-track lifetime: mean {np.mean(lt):.1f} max {np.max(lt)} obs")
    # Bias against track age (the drift signature).
    out["by_age"] = []
    print(" age  n      du0      dv0     ddisp")
    for a0, a1 in AGE_BINS:
        m = (allr[:, 4] >= a0) & (allr[:, 4] < a1)
        if m.sum():
            row = dict(age=(a0, a1), n=int(m.sum()), du=allr[m, 1].mean(), dv=allr[m, 2].mean(),
                       ddisp=allr[m, 3].mean())
            out["by_age"].append(row)
            print(f"{a0:3d}-{a1:<3d} {row['n']:5d} {row['du']:+.4f} {row['dv']:+.4f} {row['ddisp']:+.4f}")
    # Bias against the image row (normalized v of the projection):
    # position-dependent systematics (distortion, caps) against track-age
    # ones.
    out["by_row"] = []
    print("  v_n       n      du0      dv0    mean_age")
    vq = np.quantile(allr[:, 5], np.linspace(0, 1, 9))
    for lo, hi in zip(vq[:-1], vq[1:]):
        m = (allr[:, 5] >= lo) & (allr[:, 5] < hi)
        if m.sum():
            row = dict(v=(lo, hi), n=int(m.sum()), du=allr[m, 1].mean(), dv=allr[m, 2].mean(),
                       age=allr[m, 4].mean())
            out["by_row"].append(row)
            print(f"{lo:+.3f}..{hi:+.3f} {row['n']:6d} {row['du']:+.4f} {row['dv']:+.4f} {row['age']:6.1f}")
    # Age x row: per-track drift against a static position-dependent bias
    # (age and row are confounded when old tracks pool at one side).
    out["age_row"] = []
    print("dv0 by age x v_n  (rows: age bins; cols: v_n bins)")
    print("  age   " + " ".join(f"v{lo:+.1f}..{hi:+.1f}" for lo, hi in JOINT_V_BINS))
    for a0, a1 in JOINT_AGE_BINS:
        cells, vals = [], []
        for lo, hi in JOINT_V_BINS:
            m = (allr[:, 4] >= a0) & (allr[:, 4] < a1) & (allr[:, 5] >= lo) & (allr[:, 5] < hi)
            if m.sum() > 30:
                vals.append((allr[m, 2].mean(), int(m.sum())))
                cells.append(f"{vals[-1][0]:+.3f}({vals[-1][1]:4d})")
            else:
                vals.append(None)
                cells.append("    --    ")
        out["age_row"].append(vals)
        print(f"{a0:3d}-{a1:<3d} " + " ".join(cells))
    # Bias against sequence time (the scale-drift signature).
    out["by_time"] = []
    print(" t[s]   n      du0     ddisp")
    step = max(1, T // 12)
    for s in range(0, T, step):
        m = (allr[:, 0] >= s) & (allr[:, 0] < s + step)
        if m.sum():
            row = dict(t=float(frame_t[s]), n=int(m.sum()), du=allr[m, 1].mean(), ddisp=allr[m, 3].mean())
            out["by_time"].append(row)
            print(f"{row['t']:5.1f} {row['n']:6d} {row['du']:+.4f} {row['ddisp']:+.4f}")
    return out


def main(env: Mapping[str, str] = os.environ) -> dict:
    """Probe the scene ``env`` names; returns ``bias_tables``' numbers."""
    from ..sim.trajectory import make_circle_trajectory, make_stress_trajectory, make_wall_landmarks, synthesize_imu

    knobs = probe_knobs(env)
    calib = EUROC_CALIB
    if knobs.generator == "stress":
        traj = make_stress_trajectory(duration=knobs.duration)
    else:
        traj = make_circle_trajectory(duration=knobs.duration, **knobs.circle_kwargs)
    landmarks = make_wall_landmarks(num=700, radius=knobs.r_wall, z_min=-4.5, z_max=4.5, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    idx = np.arange(0, traj.t.shape[0], 10)
    fid, uv, valid = run_tracker(knobs, traj, idx, landmarks, imu, calib)
    n0, z0, n1 = ground_truth(traj, idx, landmarks, calib)
    return bias_tables(fid, uv, valid, n0, z0, n1, calib.cam0.intrinsics[0], traj.t[idx])


if __name__ == "__main__":
    main()
