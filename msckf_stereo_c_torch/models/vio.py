"""Full VIO system: front-end tracker + MSCKF back-end, one frame per step
(port of ``msckf_stereo_c_tpu/models/vio.py``).

``run_vio_sequence`` and ``init_vio_state`` run on the CUDA card unless the
caller names another device.  A sequence is one B=1 run stepped frame by
frame in a Python loop; each chunk of frames is copied to the device once,
and the per-frame outputs come back to the host once at the end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FilterConfig, FrontendConfig, StereoCalib, matmul_precision_scope, resolve_device
from ..utils.quaternion import jpl_to_rot
from . import frontend as _frontend
from . import msckf as _msckf
from .frontend import (
    FrontendParams,
    TrackerState,
    frontend_step,
    init_tracker_state,
    make_frontend_params,
    pyramids_for,
)
from .msckf import FrameFeatures, MsckfParams, filter_step, make_params
from .propagation import ImuBatch
from .runner import apply_gravity_init, pack_imu_batches
from .state import FilterState, init_filter_state


class VioState(NamedTuple):
    tracker: TrackerState
    filt: FilterState
    pyr0_prev: Tuple[torch.Tensor, ...]
    prev_time: torch.Tensor  # () previous frame time; < 0 before the first


def init_vio_state(
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    calib: StereoCalib,
    img_shape: Tuple[int, int],
    image_dtype=torch.float32,
    filter_dtype=torch.float64,
    device=None,
) -> VioState:
    """Initial state on ``device`` (the CUDA card when None; raises when
    CUDA is missing and no device was given)."""
    device = resolve_device(device)
    H, W = img_shape
    dummy = torch.zeros((H, W), dtype=image_dtype, device=device)
    return VioState(
        tracker=init_tracker_state(fcfg, image_dtype, device),
        filt=init_filter_state(mcfg, calib, filter_dtype, device),
        pyr0_prev=pyramids_for(dummy, fcfg),
        prev_time=torch.full((), -1.0, dtype=filter_dtype, device=device),
    )


def _run_frontend(state: VioState, img0, img1, time, imu: ImuBatch, fparams, fcfg):
    """Pyramids, mean gyro, frame dt and the tracker step; packs the
    filter's FrameFeatures."""
    fdtype = state.filt.P.dtype
    idtype = img0.dtype
    with matmul_precision_scope(fcfg.matmul_precision):
        pyr0 = pyramids_for(img0, fcfg)
        pyr1 = pyramids_for(img1, fcfg)

    n_valid = torch.clamp(torch.sum(imu.valid), min=1)
    mean_gyro = torch.sum(torch.where(imu.valid[:, None], imu.gyro, 0.0), dim=0) / n_valid.to(
        imu.gyro.dtype
    )
    is_first = state.prev_time < 0
    dt = torch.where(is_first, 0.0, time - state.prev_time)

    # The filter's velocity (world frame) rotated into cam0 seeds the
    # translation-aware temporal prediction.
    R_wi = jpl_to_rot(state.filt.imu.q)
    cam_vel = fparams.R_imu_cam0 @ (R_wi @ state.filt.imu.v).to(idtype)

    tracker, out = frontend_step(
        state.tracker, state.pyr0_prev, pyr0, pyr1, mean_gyro.to(idtype), dt.to(idtype),
        is_first, fparams, fcfg, cam_vel,
    )
    frame = FrameFeatures(
        time=time.to(fdtype),
        fid=out.fid,
        uv=out.uv.to(fdtype),
        valid=out.valid,
        quality=out.quality.to(fdtype),
    )
    return tracker, out, frame, pyr0


def vio_step(
    state: VioState,
    img0: torch.Tensor,
    img1: torch.Tensor,
    time: torch.Tensor,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "schur",
):
    """One stereo frame end to end.  Returns (state, (PoseOutput,
    FrameOutput))."""
    tracker, out, frame, pyr0 = _run_frontend(state, img0, img1, time, imu, fparams, fcfg)
    filt, pose = filter_step(state.filt, frame, imu, mparams, mcfg, method=method)
    new_state = VioState(
        tracker=tracker, filt=filt, pyr0_prev=pyr0, prev_time=time.to(state.filt.P.dtype)
    )
    return new_state, (pose, out)


def _on_device(x, dtype, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


@dataclasses.dataclass
class VioResult:
    times: np.ndarray
    positions: np.ndarray
    quats_xyzw: np.ndarray
    pos_cov: np.ndarray  # (T, 3, 3) body-frame position covariance
    num_tracks: np.ndarray
    tracking: dict
    final_state: VioState
    fid: Optional[np.ndarray] = None  # (T, N) int32
    uv: Optional[np.ndarray] = None  # (T, N, 4)
    valid: Optional[np.ndarray] = None  # (T, N) bool


def run_vio_sequence(
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,
    images0,  # (T, H, W) numpy array or tensor
    images1,
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    image_dtype=torch.float32,
    filter_dtype=torch.float64,
    method: str = "schur",
    chunk: Optional[int] = None,
    state: Optional[VioState] = None,
    prev_frame_t: Optional[float] = None,
    device=None,
) -> VioResult:
    """Host driver over an image sequence (reference per-image loop).
    The images may be host arrays or tensors (a tensor already on the
    device is used in place); ``chunk`` frames' images are resident on the
    device at a time.  When resuming with ``state``, pass ``prev_frame_t``
    = the last processed frame's time so the IMU samples between the calls
    are packed."""
    device = resolve_device(device)
    fcfg = dataclasses.replace(
        fcfg,
        distortion_model0=calib.cam0.distortion_model,
        distortion_model1=calib.cam1.distortion_model,
    )
    H, W = images0.shape[1:]
    _frontend.check_supported(fcfg, (H, W))
    _msckf.check_supported(mcfg, method)
    fparams = make_frontend_params(calib, image_dtype, device)
    mparams = make_params(mcfg, calib, filter_dtype, device)
    if state is None:
        state = init_vio_state(fcfg, mcfg, calib, (H, W), image_dtype, filter_dtype, device)
        n0 = min(mcfg.imu_init_samples, imu_t.shape[0])
        state = state._replace(filt=apply_gravity_init(state.filt, imu_gyro[:n0], imu_acc[:n0]))

    batches = pack_imu_batches(
        imu_t, imu_gyro, imu_acc, frame_t, mcfg.max_imu_per_frame,
        prev_frame_t=prev_frame_t, device=device,
    )
    T = frame_t.shape[0]
    chunk = chunk or T
    poses, fronts = [], []
    for s0 in range(0, T, chunk):
        s1 = min(s0 + chunk, T)
        imgs0 = _on_device(images0[s0:s1], image_dtype, device)
        imgs1 = _on_device(images1[s0:s1], image_dtype, device)
        times = torch.as_tensor(np.asarray(frame_t[s0:s1], np.float64), dtype=filter_dtype).to(device)
        for k in range(s1 - s0):
            imu = ImuBatch(*(x[s0 + k] for x in batches))
            state, (pose, front) = vio_step(
                state, imgs0[k], imgs1[k], times[k], imu, fparams, mparams, fcfg, mcfg, method
            )
            poses.append(pose)
            fronts.append(front)

    def cat(objs, field):
        return torch.stack([getattr(o, field) for o in objs]).cpu().numpy()

    return VioResult(
        times=cat(poses, "time"),
        positions=cat(poses, "p"),
        quats_xyzw=cat(poses, "q_xyzw"),
        pos_cov=cat(poses, "p_cov"),
        num_tracks=cat(poses, "num_tracks"),
        tracking={
            name: cat(fronts, name)
            for name in ("before_tracking", "after_tracking", "after_matching", "after_ransac")
        },
        final_state=state,
        fid=cat(fronts, "fid"),
        uv=cat(fronts, "uv"),
        valid=cat(fronts, "valid"),
    )
