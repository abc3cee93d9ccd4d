"""The V1_01-realistic synthetic stress gate (port of
``msckf_stereo_c_tpu/sim/stress.py``).

A long, aggressive 6-dof trajectory with near-stall stretches
(``make_stress_trajectory``), a Vicon-room-scale scene (7 m cylinder,
floor and ceiling at +/-3.5 m, ``make_room_landmarks``), the stress
schedule (texture-poor windows, an occluder sweep, exposure drift, sensor
noise, motion blur, vignetting; ``make_stress_events``), rendered on the
run's device in chunks.  The gate is ATE RMSE <= 0.13 m.

``run_stress_lanes`` runs several robustness seeds as lanes of one batched
run (``parallel/vio_multiseq.py:run_vio_batch``): each lane has its own
landmark field, IMU noise, photometric draws and images, and the lanes step
together, each kernel launching once per frame for all of them.
``run_stress_gate`` is its one-lane view.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import EUROC_CALIB, FilterConfig, FrontendConfig, StereoCalib, resolve_device
from ..convert import to_numpy
from ..io.tum import evaluate_ate
from ..models.frontend import make_frontend_params
from ..models.msckf import make_params
from ..models.propagation import ImuBatch
from ..models.runner import pack_imu_batches
from ..models.vio import VioResult, VioState
from ..parallel.vio_multiseq import batched_gravity_init, batched_init_vio_state, run_vio_batch
from ..utils.lanes import lane
from .render_torch import StressEvents, TorchRenderer, make_stress_events
from .trajectory import (
    make_circle_trajectory,
    make_fastmotion_trajectory,
    make_room_landmarks,
    make_stress_trajectory,
    synthesize_imu,
)


def protocol_lm_seed(seed: int) -> int:
    """The multi-seed protocol's landmark seed: seed 0 keeps the historical
    layout, every other seed re-draws the field."""
    return 1 if seed == 0 else 1000 + seed


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


def initial_lane_states(imus, fcfg, mcfg, calib, image_dtype, filter_dtype, device) -> VioState:
    """One lane per IMU stream of ``imus``: the initial state, gravity and
    bias set from each lane's first ``imu_init_samples`` samples."""
    H, W = calib.cam0.resolution[1], calib.cam0.resolution[0]
    states = batched_init_vio_state(fcfg, mcfg, calib, (H, W), len(imus), image_dtype, filter_dtype, device)
    n0 = mcfg.imu_init_samples
    return batched_gravity_init(
        states, np.stack([m.gyro[:n0] for m in imus]), np.stack([m.acc[:n0] for m in imus])
    )


def step_rendered_lanes(states, trajs, renderers, events, imus, frame_idx, fcfg, mcfg, calib, image_dtype,
                        filter_dtype, method, chunk, device):
    """Step B lanes over the frames ``frame_idx`` of one frame clock in
    chunks of ``chunk``: each chunk is rendered per lane on the device
    (lane b: ``renderers[b]`` along ``trajs[b]`` under ``events[b]``), its
    IMU packed from the lane's own stream ``imus[b]``, and stepped by
    ``run_vio_batch`` from the states the chunk before left.  Returns
    (states, poses, fronts): the states after the last frame and each
    chunk's PoseOutput and FrameOutput as numpy trees (``lane_series``
    joins a lane's)."""
    B = len(trajs)
    frame_t = trajs[0].t[frame_idx]
    T = len(frame_idx)
    fparams = make_frontend_params(calib, image_dtype, device)
    mparams = make_params(mcfg, calib, filter_dtype, device)
    poses, fronts = [], []
    for s0 in range(0, T, chunk):
        s1 = min(s0 + chunk, T)
        prev = float(frame_t[s0 - 1]) if s0 > 0 else None
        rendered = [r.render_sequence(tr, frame_idx[s0:s1], ev.slice(s0, s1), chunk=chunk)
                    for r, tr, ev in zip(renderers, trajs, events)]
        # One lane reads its frames as one shared stack, as a one-sequence
        # run does; several lanes read a (B, T, H, W) stack.
        img0 = torch.stack([x[0] for x in rendered]) if B > 1 else rendered[0][0]
        img1 = torch.stack([x[1] for x in rendered]) if B > 1 else rendered[0][1]
        del rendered
        # Each lane packs its own IMU stream.
        packed = [pack_imu_batches(m.t, m.gyro, m.acc, frame_t[s0:s1], mcfg.max_imu_per_frame,
                                   prev_frame_t=prev) for m in imus]
        imu = ImuBatch(*(torch.stack(x) for x in zip(*packed)))
        states, pose, front, _ = run_vio_batch(
            states, img0, img1, np.repeat(frame_t[None, s0:s1], B, axis=0), imu,
            fparams, mparams, fcfg, mcfg, method=method, device=device,
        )
        del img0, img1
        poses.append(to_numpy(pose))
        fronts.append(to_numpy(front))
    return states, poses, fronts


def lane_series(parts, field: str, b: int) -> np.ndarray:
    """Lane ``b``'s ``field`` over the chunks ``parts``, joined in time."""
    return np.concatenate([getattr(p, field)[b] for p in parts], axis=0)


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
    """Render and run the stress scene of one seed in chunks of ``chunk``
    frames on ``device`` (the CUDA card when None; raises without CUDA
    unless a device is named): the one-lane view of ``run_stress_lanes``
    (landmark seed ``lm_seed``, 1 when None)."""
    return run_stress_lanes(
        [seed], duration=duration, frame_stride=frame_stride, r_wall=r_wall, z_cap=z_cap,
        num_landmarks=num_landmarks, chunk=chunk, fcfg=fcfg, mcfg=mcfg, calib=calib,
        image_dtype=image_dtype, filter_dtype=filter_dtype, method=method,
        events=None if events is None else [events], stress=stress, traj_kwargs=traj_kwargs,
        generator=generator, lm_seeds=[1 if lm_seed is None else lm_seed],
        imu_gyro_noise=imu_gyro_noise, imu_acc_noise=imu_acc_noise, events_kwargs=events_kwargs,
        device=device,
    )[0]


def run_stress_lanes(
    seeds: Sequence[int],
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
    events: Optional[Sequence[StressEvents]] = None,
    stress: bool = True,
    traj_kwargs: Optional[dict] = None,
    generator: str = "stress",
    lm_seeds: Optional[Sequence[int]] = None,
    imu_gyro_noise: float = 5e-4,
    imu_acc_noise: float = 5e-3,
    events_kwargs: Optional[dict] = None,
    device=None,
) -> list:
    """The stress scene of each robustness seed, the seeds as the lanes of
    one batched run on ``device`` (the CUDA card when None; raises without
    CUDA unless a device is named).  Seed ``s`` draws the IMU noise and
    the photometric channels with ``s`` and its landmark field with
    ``lm_seeds`` (the protocol's ``protocol_lm_seed`` when None); one
    trajectory and frame clock serve every lane.  Each chunk of ``chunk``
    frames is rendered per lane on the device and stepped by
    ``run_vio_batch``, resuming from the states the chunk before left.
    Returns one ``StressGateResult`` per seed."""
    device = resolve_device(device)
    seeds = list(seeds)
    B = len(seeds)
    lm_seeds = [protocol_lm_seed(s) for s in seeds] if lm_seeds is None else list(lm_seeds)
    make_traj = {
        "stress": make_stress_trajectory,
        "circle": make_circle_trajectory,
        "fastmotion": make_fastmotion_trajectory,
    }[generator]
    traj = make_traj(duration=duration, **(traj_kwargs or {}))
    frame_idx = np.arange(0, traj.t.shape[0], frame_stride)
    frame_t = traj.t[frame_idx]
    T = len(frame_idx)
    imus = [synthesize_imu(traj, gyro_noise=imu_gyro_noise, acc_noise=imu_acc_noise, seed=s) for s in seeds]
    if events is not None:
        evs = list(events)
    elif stress:
        # The photometric channels draw with the robustness seed too.
        evs = [make_stress_events(traj, frame_idx, noise_seed=s, **(events_kwargs or {})) for s in seeds]
    else:
        evs = [StressEvents.nominal(T)] * B
    renderers = [
        TorchRenderer(
            make_room_landmarks(num=num_landmarks, radius=r_wall, z_cap=z_cap, seed=ls),
            calib, r_wall=r_wall, z_cap=z_cap, device=device,
        )
        for ls in lm_seeds
    ]

    fcfg = dataclasses.replace(
        fcfg or FrontendConfig(),
        distortion_model0=calib.cam0.distortion_model,
        distortion_model1=calib.cam1.distortion_model,
    )
    mcfg = mcfg or FilterConfig(ns_iters=10 if method == "schur" else 0)
    states = initial_lane_states(imus, fcfg, mcfg, calib, image_dtype, filter_dtype, device)
    states, poses, fronts = step_rendered_lanes(
        states, [traj] * B, renderers, evs, imus, frame_idx, fcfg, mcfg, calib, image_dtype, filter_dtype,
        method, chunk, device,
    )

    gt_p = traj.p[frame_idx]
    out = []
    for b in range(B):
        full = VioResult(
            times=lane_series(poses, "time", b),
            positions=lane_series(poses, "p", b),
            quats_xyzw=lane_series(poses, "q_xyzw", b),
            pos_cov=lane_series(poses, "p_cov", b),
            num_tracks=lane_series(poses, "num_tracks", b),
            tracking={k: lane_series(fronts, k, b) for k in
                      ("before_tracking", "after_tracking", "after_matching", "after_ransac")},
            final_state=lane(states, b),
            fid=lane_series(fronts, "fid", b),
            uv=lane_series(fronts, "uv", b),
            valid=lane_series(fronts, "valid", b),
        )
        ate = evaluate_ate(full.times, full.positions, frame_t, gt_p)
        out.append(StressGateResult(
            ate_rmse=float(ate.rmse),
            ate_mean=float(ate.mean),
            ate_max=float(ate.max),
            duration=float(frame_t[-1] - frame_t[0]),
            n_frames=T,
            min_tracks_after_ransac=int(full.tracking["after_ransac"][5:].min()),
            result=full,
            gt_t=frame_t,
            gt_p=gt_p,
        ))
    return out
