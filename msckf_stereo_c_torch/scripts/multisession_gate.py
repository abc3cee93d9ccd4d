"""The multi-session map-alignment gate on the port (port of
``scripts/multisession_gate.py``, the BASELINE config-5 artifact).

    python -m msckf_stereo_c_torch.scripts.multisession_gate

Two VIO sessions of one synthetic room start from different poses; each
runs the full pipeline (render on the device -> front-end kernels -> MSCKF)
in its own odometry frame, the two as the lanes of one batched run.  A
coarse dock prior (the true inter-start transform plus injected operator
noise) seeds cross-session landmark association; a swept global Kabsch fit
(ICP) over the matched landmark clouds refines the alignment;
per-keyframe landmark-set fits become inter-session relative-pose edges;
and the joint pose graph (odometry chains plus inter-session edges) is
solved on the device, sharded over the ranks of a process group of two or
more.

Reported: per-session ATE and the joint ATE of the concatenated two-session
trajectory at three tiers (prior only, global landmark alignment, pose
graph), each through one Horn alignment of the joint set, with the wall
time split into sessions, alignment and graph.

Knobs (environment): MS_DURATION (s, default 40), MS_DEVICE (``cpu``
selects the CPU; the CUDA card otherwise), MS_SEED, MS_PRIOR_YAW_DEG /
MS_PRIOR_TRANS (injected prior noise, default 10 deg / 0.75 m), MS_STRIDE,
MS_CHUNK, MS_GRAPH_ITERS, MS_INTER_WEIGHT, MS_CACHE (default 1: keep the
finished sessions under ``build/multisession/``, keyed by a hash of the
package's sources and the run's configuration).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
import zipfile
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import EUROC_CALIB, FilterConfig, FrontendConfig, resolve_device
from ..io.tum import evaluate_ate
from ..parallel.collectives import resolve_group
from ..parallel.multisession import (
    DZ_SWEEP_M,
    XY_SWEEP_M,
    YAW_SWEEP_DEG,
    SessionData,
    apply_rigid,
    build_joint_graph,
    intersession_edges,
    optimize_joint,
    refine_alignment,
    relative_prior,
    session_frame_transform,
)
from ..parallel.refine import build_ba_problem
from ..sim.render_torch import StressEvents, TorchRenderer
from ..sim.stress import initial_lane_states, lane_series, step_rendered_lanes
from ..sim.trajectory import (
    make_circle_trajectory,
    make_room_landmarks,
    synthesize_imu,
    transform_trajectory,
)

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(os.path.dirname(PKG), "build", "multisession")
SESSION_KEYS = ("kf_times", "q", "p", "landmarks", "lm_mask", "frame_w_R", "frame_w_t", "ate", "gt_kf")


def session_specs(duration: float, seed: int = 0):
    """(name, trajectory, IMU seed) of the two sessions: A on the inner
    orbit, B on another orbit of the same room from a different start pose
    (world yaw + offset)."""
    trajA = make_circle_trajectory(duration=duration, radius=3.0, z_amp=0.5)
    trajB = transform_trajectory(
        make_circle_trajectory(duration=duration, radius=2.5, z_amp=0.35, omega=2.0 * np.pi / 17.0),
        yaw=np.deg2rad(55.0),
        offset=(0.7, -0.5, 0.15),
    )
    return [("A", trajA, seed), ("B", trajB, seed + 100)]


def run_sessions(
    specs: Sequence,
    keyframe_stride: int = 5,
    chunk: int = 64,
    filter_dtype=torch.float32,
    device=None,
    verbose: bool = True,
) -> dict:
    """Run the sessions of ``specs`` as the lanes of one chunked
    ``run_vio_batch`` on ``device`` (the CUDA card when None) and keyframe
    and triangulate each (``build_ba_problem``).  Every lane has its own
    trajectory, IMU stream, gravity init and images, rendered on the device
    over the shared room.  Returns numpy arrays per session s:
    kf_times_s, q_s, p_s, landmarks_s, lm_mask_s, frame_w_R_s, frame_w_t_s,
    ate_s, gt_kf_s."""
    device = resolve_device(device)
    B = len(specs)
    calib = EUROC_CALIB
    fcfg = dataclasses.replace(
        FrontendConfig(),
        distortion_model0=calib.cam0.distortion_model,
        distortion_model1=calib.cam1.distortion_model,
    )
    mcfg = FilterConfig(ns_iters=10)
    renderer = TorchRenderer(make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1), calib,
                             r_wall=7.0, z_cap=3.5, device=device)
    trajs = [traj for _, traj, _ in specs]
    imus = [synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=s) for _, traj, s in specs]
    frame_idx = np.arange(0, trajs[0].t.shape[0], 10)
    frame_t = trajs[0].t[frame_idx]
    T = len(frame_idx)
    states = initial_lane_states(imus, fcfg, mcfg, calib, torch.float32, filter_dtype, device)
    # Each session's odometry frame is defined by its own gravity init.
    q0 = states.filt.imu.q.detach().cpu().numpy()
    _, poses, fronts = step_rendered_lanes(
        states, trajs, [renderer] * B, [StressEvents.nominal(T)] * B, imus, frame_idx, fcfg, mcfg, calib,
        torch.float32, filter_dtype, "schur", chunk, device,
    )

    out = {}
    for b, (name, traj, _) in enumerate(specs):
        positions, quats = lane_series(poses, "p", b), lane_series(poses, "q_xyzw", b)
        prob = build_ba_problem(
            frame_t, quats, positions, *(lane_series(fronts, f, b) for f in ("fid", "uv", "valid")), calib=calib, keyframe_stride=keyframe_stride, max_keyframes=10_000, max_landmarks=400,
            device=device,
        )
        if prob is None:
            raise RuntimeError(f"session {name}: too few tracks for BA")
        F = prob.cam_q.shape[0]
        kf = np.arange(0, T, keyframe_stride)[:F]
        ate = evaluate_ate(frame_t, positions, frame_t, traj.p[frame_idx])
        frame_w = session_frame_transform(q0[b], traj.R_w_b[0], traj.p[0])
        landmarks = prob.landmarks.cpu().numpy()
        if verbose:
            print(f"session {name}: {T} frames, ATE {ate.rmse:.4f} m, {F} keyframes, "
                  f"{len(landmarks)} landmarks", flush=True)
        out[f"kf_times_{name}"] = frame_t[kf]
        out[f"q_{name}"] = quats[kf]  # published Hamilton xyzw == JPL world->body
        out[f"p_{name}"] = positions[kf]
        out[f"landmarks_{name}"] = landmarks
        out[f"lm_mask_{name}"] = prob.mask.cpu().numpy()
        out[f"frame_w_R_{name}"] = frame_w[0]
        out[f"frame_w_t_{name}"] = frame_w[1]
        out[f"ate_{name}"] = np.float64(ate.rmse)
        out[f"gt_kf_{name}"] = traj.p[frame_idx[kf]]
    return out


def compute_sessions(
    duration: float = 40.0,
    seed: int = 0,
    keyframe_stride: int = 5,
    chunk: int = 64,
    verbose: bool = True,
    filter_dtype=torch.float32,
    device=None,
) -> dict:
    """Sessions A and B (``session_specs``) as the two lanes of one run:
    ``run_sessions``' dict (plain numpy arrays, cacheable)."""
    return run_sessions(session_specs(duration, seed), keyframe_stride=keyframe_stride, chunk=chunk,
                        filter_dtype=filter_dtype, device=device, verbose=verbose)


def sweep_ranges(prior_yaw_deg: float, prior_trans_m: float):
    """The alignment sweep's half-ranges for a prior of this noise: JAX's
    grid, widened to 3 sigma of the prior where that is wider."""
    return dict(yaw_sweep_deg=max(YAW_SWEEP_DEG, 3.0 * prior_yaw_deg),
                dz_sweep_m=max(DZ_SWEEP_M, 3.0 * prior_trans_m),
                xy_sweep_m=max(XY_SWEEP_M, 3.0 * prior_trans_m))


def align_and_solve(
    sess: dict,
    seed: int = 0,
    prior_yaw_deg: float = 10.0,
    prior_trans_m: float = 0.75,
    graph_iters: int = 12,
    inter_weight: float = 1.0,
    use_group: bool = True,
    sweep: Optional[dict] = None,
    device=None,
    verbose: bool = True,
) -> dict:
    """The alignment and joint-graph tiers on finished sessions.  The sweep
    takes ``sweep``'s half-ranges (``refine_alignment``'s keywords;
    ``sweep_ranges`` of the prior when None).  With ``use_group`` and an
    initialised process group of two or more ranks, the graph is solved by
    the sharded runner over it.  Returns the result dict (without the
    sessions' wall time)."""
    device = resolve_device(device)
    sessA, sessB = (
        SessionData(kf_times=sess[f"kf_times_{s}"], q=sess[f"q_{s}"], p=sess[f"p_{s}"],
                    landmarks=sess[f"landmarks_{s}"], lm_mask=sess[f"lm_mask_{s}"])
        for s in "AB"
    )
    frameA = (sess["frame_w_R_A"], sess["frame_w_t_A"])
    frameB = (sess["frame_w_R_B"], sess["frame_w_t_B"])
    t0 = time.perf_counter()

    # Coarse dock prior with injected operator noise.
    R_ab, t_ab = relative_prior(frameA, frameB, yaw_noise_rad=np.deg2rad(prior_yaw_deg),
                                trans_noise_m=prior_trans_m, seed=seed)
    _, pB_prior = apply_rigid(R_ab, t_ab, sessB.q, sessB.p)
    lmsB_prior = sessB.landmarks @ R_ab.T + t_ab

    # Joint two-session ATE: one Horn alignment over the concatenated
    # keyframe sets, so inter-session misalignment cannot be aligned away.
    t_all = np.concatenate([sessA.kf_times, sessB.kf_times + 1e4])
    gt_all = np.concatenate([sess["gt_kf_A"], sess["gt_kf_B"]])
    Fa = len(sessA.kf_times)

    def joint_ate(pA, pB):
        return float(evaluate_ate(t_all, np.concatenate([pA, pB]), t_all, gt_all).rmse)

    before = joint_ate(sessA.p, pB_prior)

    # Tier 2: the swept global Kabsch fit over the matched landmark clouds.
    ranges = sweep_ranges(prior_yaw_deg, prior_trans_m) if sweep is None else sweep
    R_g, t_g, ia, ib = refine_alignment(sessA.landmarks, lmsB_prior, device=device, **ranges)
    R_tot = R_g @ R_ab
    t_tot = R_g @ t_ab + t_g
    qB_a, pB_a = apply_rigid(R_tot, t_tot, sessB.q, sessB.p)
    lmsB_a = sessB.landmarks @ R_tot.T + t_tot
    mid = joint_ate(sessA.p, pB_a)
    if verbose:
        print(f"global alignment: {len(ia)} landmark matches, joint ATE {before:.4f} -> {mid:.4f} m", flush=True)

    sessB_in_a = SessionData(kf_times=sessB.kf_times + 1e4, q=qB_a, p=pB_a, landmarks=lmsB_a,
                             lm_mask=sessB.lm_mask)
    inter = intersession_edges(sessA, sessB_in_a, ia, ib, min_common=6, max_edges=96, weight=inter_weight)
    n_inter = len(inter[0])
    if verbose:
        print(f"cross-session: {n_inter} edges", flush=True)
    if n_inter < 3:
        raise RuntimeError(f"too few inter-session edges ({n_inter})")
    t1 = time.perf_counter()

    group, world, _ = resolve_group(None) if use_group else (None, 1, 0)
    if world < 2:
        group = None
    graph = build_joint_graph(sessA, sessB_in_a, inter, device=device)
    refined, costs = optimize_joint(graph, group=group, iters=graph_iters)
    p_opt = refined.p.cpu().numpy()
    costs = costs.cpu().numpy()
    t2 = time.perf_counter()
    after = joint_ate(p_opt[:Fa], p_opt[Fa:len(t_all)])

    return {
        "metric": "multisession_joint_ate",
        "value": after,
        "joint_ate_prior": before,
        "joint_ate_global_align": mid,
        "joint_ate_after_graph": after,
        "improvement_x": before / max(after, 1e-9),
        "ate_session_a": float(sess["ate_A"]),
        "ate_session_b": float(sess["ate_B"]),
        "landmark_matches": int(len(ia)),
        "inter_edges": int(n_inter),
        "graph_nodes": int(p_opt.shape[0]),
        "cost_drop": float(costs[0] / max(float(costs[-1]), 1e-30)),
        "mesh_devices": 0 if group is None else world,
        "prior_noise": f"{prior_yaw_deg} deg / {prior_trans_m} m",
        "sweep": ranges,
        "wall_align_s": t1 - t0,
        "wall_graph_s": t2 - t1,
    }


def _cache_path(config: dict) -> str:
    """The session cache's file for ``config``: keyed by a hash of the
    package's sources and the run's configuration."""
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith((".py", ".cu")):
                path = os.path.join(dirpath, f)
                h.update(os.path.relpath(path, PKG).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return os.path.join(CACHE_DIR, f"sessions_{h.hexdigest()[:20]}.npz")


def _read_cache(path: str) -> Optional[dict]:
    """The cached sessions, or None when the file is missing, corrupt,
    truncated or incomplete (the caller recomputes)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            sess = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        print(f"session cache {path} unreadable ({e}); recomputing", file=sys.stderr, flush=True)
        return None
    if any(f"{k}_{s}" not in sess for k in SESSION_KEYS for s in "AB"):
        print(f"session cache {path} incomplete; recomputing", file=sys.stderr, flush=True)
        return None
    return sess


def _write_cache(path: str, sess: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **sess)
    os.replace(tmp, path)


def run_multisession(
    duration: float = 40.0,
    seed: int = 0,
    prior_yaw_deg: float = 10.0,
    prior_trans_m: float = 0.75,
    keyframe_stride: int = 5,
    chunk: int = 64,
    graph_iters: int = 12,
    inter_weight: float = 1.0,
    use_group: bool = True,
    verbose: bool = True,
    cache: bool = True,
    device=None,
) -> dict:
    """The gate: sessions (from the cache when ``cache`` and a valid entry
    exists), then ``align_and_solve``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    sess = None
    path = None
    if cache:
        path = _cache_path(dict(duration=duration, seed=seed, keyframe_stride=keyframe_stride, chunk=chunk,
                                device=device.type))
        sess = _read_cache(path)
        if sess is not None and verbose:
            print(f"sessions from cache {path}", flush=True)
    if sess is None:
        sess = compute_sessions(duration=duration, seed=seed, keyframe_stride=keyframe_stride, chunk=chunk,
                                verbose=verbose, device=device)
        if path:
            _write_cache(path, sess)
    t1 = time.perf_counter()
    out = align_and_solve(sess, seed=seed, prior_yaw_deg=prior_yaw_deg, prior_trans_m=prior_trans_m,
                          graph_iters=graph_iters, inter_weight=inter_weight, use_group=use_group,
                          device=device, verbose=verbose)
    out["unit"] = "m"
    out["duration_s"] = duration
    out["wall_sessions_s"] = t1 - t0
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(env: Mapping[str, str] = os.environ) -> dict:
    out = run_multisession(
        duration=float(env.get("MS_DURATION", "40")),
        seed=int(env.get("MS_SEED", "0")),
        prior_yaw_deg=float(env.get("MS_PRIOR_YAW_DEG", "10")),
        prior_trans_m=float(env.get("MS_PRIOR_TRANS", "0.75")),
        keyframe_stride=int(env.get("MS_STRIDE", "5")),
        chunk=int(env.get("MS_CHUNK", "64")),
        graph_iters=int(env.get("MS_GRAPH_ITERS", "12")),
        inter_weight=float(env.get("MS_INTER_WEIGHT", "1.0")),
        cache=env.get("MS_CACHE", "1") == "1",
        device=env.get("MS_DEVICE"),
    )
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
