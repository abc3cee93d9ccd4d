"""Full VIO system: front-end tracker + MSCKF back-end, one frame per step
(port of ``msckf_stereo_c_tpu/models/vio.py``).

``batched_vio_step`` steps B independent sequences together (the JAX
package's ``jax.vmap(vio_step)``): every state tensor carries a leading lane
axis, and the images come per lane as (B, H, W) or shared by every lane as
(H, W).  ``vio_step`` is its one-lane view and ``run_vio_sequence`` drives
one sequence frame by frame in a Python loop; each chunk of frames is
copied to the device once, and the per-frame outputs come back to the host
once at the end.  ``vio_step_internals`` is the differential-debug view of
one frame.  ``run_vio_sequence`` and ``init_vio_state`` run on the CUDA
card unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FilterConfig, FrontendConfig, StereoCalib, matmul_precision_scope, resolve_device
from ..ops.pyramid import blank_pyramid
from ..utils.lanes import add_lane_axis, drop_lane_axis, map_tree
from ..utils.quaternion import jpl_to_rot
from ..utils.timing import span
from . import msckf as _msckf
from .frontend import (
    FrameOutput,
    FrontendParams,
    TrackerState,
    batched_frontend_step,
    init_tracker_state,
    make_frontend_params,
    pyramids_for,
)
from .msckf import FrameFeatures, MsckfParams, PoseOutput, batched_filter_step, make_params
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
    """Initial state of one sequence on ``device`` (the CUDA card when None;
    raises when CUDA is missing and no device was given)."""
    device = resolve_device(device)
    H, W = img_shape
    return VioState(
        tracker=init_tracker_state(fcfg, image_dtype, device),
        filt=init_filter_state(mcfg, calib, filter_dtype, device),
        # pyramids_for of an all-zero image, made without a blur.
        pyr0_prev=tuple(blank_pyramid((H, W), fcfg.pyramid_levels, image_dtype, device)),
        prev_time=torch.full((), -1.0, dtype=filter_dtype, device=device),
    )


def lane_pyramids(img: torch.Tensor, B: int, fcfg: FrontendConfig) -> Tuple[torch.Tensor, ...]:
    """Pyramid levels (B, h, w) of per-lane images (B, H, W), or of one
    image (H, W) shared by the B lanes: built once and broadcast, never
    copied B times."""
    if img.dim() == 2:
        return tuple(lvl.expand(B, *lvl.shape) for lvl in pyramids_for(img, fcfg))
    # One frame of a (B, T, H, W) clip is a strided view; the kernels read
    # contiguous stacks.
    return pyramids_for(img.contiguous(), fcfg)


def _run_frontend(state: VioState, img0, img1, time, imu: ImuBatch, fparams, fcfg):
    """Pyramids, mean gyro, frame dt and the tracker step of every lane;
    packs the filter's FrameFeatures."""
    fdtype = state.filt.P.dtype
    idtype = img0.dtype
    B = state.prev_time.shape[0]
    with matmul_precision_scope(fcfg.matmul_precision), span("frontend.pyramids"):
        pyr0 = lane_pyramids(img0, B, fcfg)
        pyr1 = lane_pyramids(img1, B, fcfg)

    n_valid = torch.clamp(torch.sum(imu.valid, dim=1), min=1)
    mean_gyro = torch.sum(torch.where(imu.valid[..., None], imu.gyro, 0.0), dim=1) / n_valid[:, None].to(
        imu.gyro.dtype
    )
    is_first = state.prev_time < 0
    dt = torch.where(is_first, 0.0, time - state.prev_time)

    # The filter's velocity (world frame) rotated into cam0 seeds the
    # translation-aware temporal prediction; without translation_seed the
    # tracker predicts from rotation only.
    cam_vel = None
    if fcfg.translation_seed:
        R_wi = jpl_to_rot(state.filt.imu.q)
        v_i = (R_wi @ state.filt.imu.v[..., None])[..., 0]
        cam_vel = v_i.to(idtype) @ fparams.R_imu_cam0.T

    tracker, out = batched_frontend_step(
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


def batched_vio_step(
    state: VioState,
    img0: torch.Tensor,
    img1: torch.Tensor,
    time: torch.Tensor,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "qr",
):
    """One stereo frame of B sequences end to end: ``state`` with a leading
    lane axis, images (B, H, W) per lane or (H, W) shared, ``time`` (B,),
    ``imu`` (B, L, ...).  Every kernel launches once for all lanes.
    Returns (state, (PoseOutput, FrameOutput)), each with a leading B."""
    with span("vio.step"):
        with span("frontend"):
            tracker, out, frame, pyr0 = _run_frontend(state, img0, img1, time, imu, fparams, fcfg)
        filt, pose = batched_filter_step(state.filt, frame, imu, mparams, mcfg, method=method)
        new_state = VioState(
            tracker=tracker, filt=filt, pyr0_prev=pyr0, prev_time=time.to(state.filt.P.dtype)
        )
        return new_state, (pose, out)


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
    method: str = "qr",
):
    """One stereo frame of one sequence end to end: the one-lane view of
    ``batched_vio_step`` (images (H, W)).  Returns (state, (PoseOutput,
    FrameOutput))."""
    state, outs = batched_vio_step(
        add_lane_axis(state), img0, img1, time.reshape(1), add_lane_axis(imu),
        fparams, mparams, fcfg, mcfg, method,
    )
    return drop_lane_axis(state), drop_lane_axis(outs)


def vio_step_internals(
    state: VioState,
    img0: torch.Tensor,
    img1: torch.Tensor,
    time: torch.Tensor,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "qr",
) -> dict:
    """Differential-debug view of one sequence's frame: the frontend runs
    as ``vio_step`` runs it, then ``msckf.filter_internals`` returns the
    update-phase tensors the filter would consume, without advancing any
    state.  Adds the frontend's published ids, observations and validity."""
    _, out, frame, _ = _run_frontend(
        add_lane_axis(state), img0, img1, time.reshape(1), add_lane_axis(imu), fparams, fcfg
    )
    internals = _msckf.filter_internals(
        state.filt, drop_lane_axis(frame), imu, mparams, mcfg, method=method
    )
    internals["frontend_fid"] = out.fid[0]
    internals["frontend_uv"] = out.uv[0]
    internals["frontend_valid"] = out.valid[0]
    return internals


def step_frames(
    state: VioState,
    imgs0: torch.Tensor,
    imgs1: torch.Tensor,
    times: torch.Tensor,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "qr",
) -> Tuple[VioState, List[PoseOutput], List[FrameOutput]]:
    """``batched_vio_step`` over T frames of B lanes, one Python step per
    frame: images (B, T, H, W) per lane or (T, H, W) shared, ``times``
    (B, T), ``imu`` (B, T, L, ...), all on the state's device.  Returns the
    state after the last frame and the per-frame outputs (lists of length
    T, each with a leading B)."""
    poses, fronts = [], []
    for k in range(times.shape[1]):
        i0 = imgs0[k] if imgs0.dim() == 3 else imgs0[:, k]
        i1 = imgs1[k] if imgs1.dim() == 3 else imgs1[:, k]
        state, (pose, front) = batched_vio_step(
            state, i0, i1, times[:, k], map_tree(lambda x: x[:, k], imu),
            fparams, mparams, fcfg, mcfg, method,
        )
        poses.append(pose)
        fronts.append(front)
    return state, poses, fronts


def stack_frames(outs):
    """Per-frame outputs (each with a leading B) -> one tree (B, T, ...)."""
    return type(outs[0])(*(torch.stack(list(x), dim=1) for x in zip(*outs)))


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
    # Filled only when run_vio_sequence(internals_at=N): frame N's
    # vio_step_internals, as numpy arrays.
    internals: Optional[dict] = None


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
    method: str = "qr",
    chunk: Optional[int] = None,
    state: Optional[VioState] = None,
    internals_at: Optional[int] = None,
    prev_frame_t: Optional[float] = None,
    device=None,
) -> VioResult:
    """Host driver over one image sequence (reference per-image loop), a
    batch of one lane.  The images may be host arrays or tensors (a tensor
    already on the device is used in place); ``chunk`` frames' images are
    resident on the device at a time.  ``internals_at=N`` also captures
    frame N's ``vio_step_internals`` in ``result.internals``, from the state
    before frame N, without changing the run (it starts a chunk there, as
    in JAX).  When resuming with ``state``, pass ``prev_frame_t`` = the
    last processed frame's time so the IMU samples between the calls are
    packed."""
    device = resolve_device(device)
    fcfg = dataclasses.replace(
        fcfg,
        distortion_model0=calib.cam0.distortion_model,
        distortion_model1=calib.cam1.distortion_model,
    )
    H, W = images0.shape[1:]
    _msckf.check_supported(mcfg, method)
    fparams = make_frontend_params(calib, image_dtype, device)
    mparams = make_params(mcfg, calib, filter_dtype, device)
    if state is None:
        state = init_vio_state(fcfg, mcfg, calib, (H, W), image_dtype, filter_dtype, device)
        n0 = min(mcfg.imu_init_samples, imu_t.shape[0])
        state = state._replace(filt=apply_gravity_init(state.filt, imu_gyro[:n0], imu_acc[:n0]))

    batches = add_lane_axis(pack_imu_batches(
        imu_t, imu_gyro, imu_acc, frame_t, mcfg.max_imu_per_frame,
        prev_frame_t=prev_frame_t, device=device,
    ))
    T = frame_t.shape[0]
    chunk = chunk or T
    bounds = list(range(0, T, chunk))
    if internals_at is not None and 0 <= internals_at < T:
        bounds = sorted(set(bounds) | {internals_at})
    state = add_lane_axis(state)
    poses, fronts = [], []
    internals = None
    for j, s0 in enumerate(bounds):
        s1 = bounds[j + 1] if j + 1 < len(bounds) else T
        imgs0 = _on_device(images0[s0:s1], image_dtype, device)
        imgs1 = _on_device(images1[s0:s1], image_dtype, device)
        times = torch.as_tensor(np.asarray(frame_t[s0:s1], np.float64), dtype=filter_dtype).to(device)
        imu = map_tree(lambda x: x[:, s0:s1], batches)
        if s0 == internals_at:
            d = vio_step_internals(
                drop_lane_axis(state), imgs0[0], imgs1[0], times[0], map_tree(lambda x: x[0, 0], imu),
                fparams, mparams, fcfg, mcfg, method,
            )
            internals = {k: v.cpu().numpy() for k, v in d.items()}
        state, p, f = step_frames(
            state, imgs0, imgs1, times[None], imu, fparams, mparams, fcfg, mcfg, method,
        )
        poses += p
        fronts += f

    def cat(objs, field):
        return torch.stack([getattr(o, field)[0] for o in objs]).cpu().numpy()

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
        final_state=drop_lane_axis(state),
        fid=cat(fronts, "fid"),
        uv=cat(fronts, "uv"),
        valid=cat(fronts, "valid"),
        internals=internals,
    )
