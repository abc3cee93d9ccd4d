"""The V1_01-realistic synthetic stress gate (port of
``msckf_stereo_c_tpu/sim/stress.py``).

A long, aggressive 6-dof trajectory with near-stall stretches
(``make_stress_trajectory``), a Vicon-room-scale scene (7 m cylinder,
floor and ceiling at +/-3.5 m, ``make_room_landmarks``), the stress
schedule (texture-poor windows, an occluder sweep, exposure drift, sensor
noise, motion blur, vignetting; ``make_stress_events``), rendered on the
run's device in chunks and fed chunk by chunk to ``run_vio_sequence``.
The gate is ATE RMSE <= 0.13 m.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import EUROC_CALIB, FilterConfig, FrontendConfig, StereoCalib, resolve_device
from ..io.tum import evaluate_ate
from ..models.vio import VioResult, run_vio_sequence
from .render_torch import StressEvents, TorchRenderer, make_stress_events
from .trajectory import (
    make_circle_trajectory,
    make_fastmotion_trajectory,
    make_room_landmarks,
    make_stress_trajectory,
    synthesize_imu,
)


@dataclasses.dataclass
class StressGateResult:
    ate_rmse: float
    ate_mean: float
    ate_max: float
    duration: float
    n_frames: int
    min_tracks_after_ransac: int
    result: VioResult
    gt_t: np.ndarray
    gt_p: np.ndarray


def run_stress_gate(
    duration: float = 130.0,
    frame_stride: int = 10,
    r_wall: float = 7.0,
    z_cap: float = 3.5,
    num_landmarks: int = 900,
    chunk: int = 64,
    fcfg: Optional[FrontendConfig] = None,
    mcfg: Optional[FilterConfig] = None,
    calib: StereoCalib = EUROC_CALIB,
    image_dtype=torch.float32,
    filter_dtype=torch.float32,
    method: str = "schur",
    events: Optional[StressEvents] = None,
    stress: bool = True,
    seed: int = 0,
    traj_kwargs: Optional[dict] = None,
    generator: str = "stress",
    lm_seed: Optional[int] = None,
    imu_gyro_noise: float = 5e-4,
    imu_acc_noise: float = 5e-3,
    events_kwargs: Optional[dict] = None,
    device=None,
) -> StressGateResult:
    """Render and run the stress scene in chunks of ``chunk`` frames on
    ``device`` (the CUDA card when None; raises without CUDA unless a
    device is named): each chunk is rendered there and goes straight into
    ``run_vio_sequence``, resuming from the state the chunk before left."""
    device = resolve_device(device)
    make_traj = {
        "stress": make_stress_trajectory,
        "circle": make_circle_trajectory,
        "fastmotion": make_fastmotion_trajectory,
    }[generator]
    traj = make_traj(duration=duration, **(traj_kwargs or {}))
    landmarks = make_room_landmarks(
        num=num_landmarks, radius=r_wall, z_cap=z_cap, seed=1 if lm_seed is None else lm_seed
    )
    imu = synthesize_imu(traj, gyro_noise=imu_gyro_noise, acc_noise=imu_acc_noise, seed=seed)
    frame_idx = np.arange(0, traj.t.shape[0], frame_stride)
    frame_t = traj.t[frame_idx]
    T = len(frame_idx)

    if events is not None:
        ev = events
    elif stress:
        # The photometric channels draw with the robustness seed too.
        ev = make_stress_events(traj, frame_idx, noise_seed=seed, **(events_kwargs or {}))
    else:
        ev = StressEvents.nominal(T)
    renderer = TorchRenderer(landmarks, calib, r_wall=r_wall, z_cap=z_cap, device=device)

    fcfg = fcfg or FrontendConfig()
    mcfg = mcfg or FilterConfig(ns_iters=10 if method == "schur" else 0)

    state = None
    results = []
    for s0 in range(0, T, chunk):
        s1 = min(s0 + chunk, T)
        img0, img1 = renderer.render_sequence(traj, frame_idx[s0:s1], ev.slice(s0, s1), chunk=chunk)
        res = run_vio_sequence(
            fcfg, mcfg, calib, frame_t[s0:s1], img0, img1, imu.t, imu.gyro, imu.acc,
            image_dtype=image_dtype, filter_dtype=filter_dtype, method=method,
            state=state, prev_frame_t=float(frame_t[s0 - 1]) if s0 > 0 else None,
            device=device,
        )
        del img0, img1
        state = res.final_state
        results.append(res)

    def cat(field):
        return np.concatenate([getattr(r, field) for r in results], axis=0)

    full = VioResult(
        times=cat("times"),
        positions=cat("positions"),
        quats_xyzw=cat("quats_xyzw"),
        pos_cov=cat("pos_cov"),
        num_tracks=cat("num_tracks"),
        tracking={k: np.concatenate([r.tracking[k] for r in results]) for k in results[0].tracking},
        final_state=state,
        fid=cat("fid"),
        uv=cat("uv"),
        valid=cat("valid"),
    )
    gt_t, gt_p = frame_t, traj.p[frame_idx]
    ate = evaluate_ate(full.times, full.positions, gt_t, gt_p)
    return StressGateResult(
        ate_rmse=float(ate.rmse),
        ate_mean=float(ate.mean),
        ate_max=float(ate.max),
        duration=float(frame_t[-1] - frame_t[0]),
        n_frames=T,
        min_tracks_after_ransac=int(full.tracking["after_ransac"][5:].min()),
        result=full,
        gt_t=gt_t,
        gt_p=gt_p,
    )
