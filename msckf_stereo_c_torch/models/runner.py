"""Host-side sequence driving (port of ``msckf_stereo_c_tpu/models/
runner.py``): per-frame IMU packing, the gravity/bias initialization, and
``run_sequence``, the filter-only driver over recorded feature frames."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import FilterConfig, StereoCalib, resolve_device
from ..utils.lanes import add_lane_axis, drop_lane_axis, map_tree
from .msckf import FrameFeatures, MsckfParams, batched_filter_step, make_params
from .propagation import ImuBatch, initialize_gravity_bias
from .state import FilterState, init_filter_state


def pack_imu_batches(
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    frame_t: np.ndarray,
    max_per_frame: int,
    dtype=np.float64,
    prev_frame_t=None,
    device=None,
) -> ImuBatch:
    """Slice the IMU stream into (T, L) per-frame batches, valid samples
    first.  Frame k gets samples with t in (frame_{k-1}, frame_k] (frame 0:
    everything up to its own time when ``prev_frame_t`` is None).  ``dt``
    carries host-exact float64 deltas chained across frames; -1 asks the
    device to derive the delta from the state clock.  Returned as tensors
    on ``device`` (CPU when None).

    With ``frame_t`` (B, T), the frame times of B sequences over the one
    IMU stream, each lane is packed on its own (``prev_frame_t`` then None
    or one time per lane) and the batches stack to (B, T, L, ...)."""
    frame_t = np.asarray(frame_t)
    if frame_t.ndim == 2:
        prev = [None] * frame_t.shape[0] if prev_frame_t is None else list(prev_frame_t)
        lanes = [
            _pack_lane(imu_t, imu_gyro, imu_acc, ft, max_per_frame, dtype, p)
            for ft, p in zip(frame_t, prev)
        ]
        return ImuBatch(*(torch.as_tensor(np.stack(x), device=device) for x in zip(*lanes)))
    lane = _pack_lane(imu_t, imu_gyro, imu_acc, frame_t, max_per_frame, dtype, prev_frame_t)
    return ImuBatch(*(torch.as_tensor(x, device=device) for x in lane))


def _pack_lane(imu_t, imu_gyro, imu_acc, frame_t, max_per_frame, dtype, prev_frame_t):
    """numpy (time, gyro, acc, valid, dt) of one sequence's batches."""
    T = frame_t.shape[0]
    L = max_per_frame
    out_t = np.zeros((T, L), dtype)
    out_g = np.zeros((T, L, 3), dtype)
    out_a = np.zeros((T, L, 3), dtype)
    out_v = np.zeros((T, L), bool)
    out_dt = np.zeros((T, L), dtype)

    if prev_frame_t is None:
        first_bound = -np.inf
        t_carry = None
    else:
        first_bound = prev_frame_t
        j = int(np.searchsorted(imu_t, prev_frame_t, side="right"))
        t_carry = float(imu_t[j - 1]) if j > 0 else float(prev_frame_t)
    lo = np.searchsorted(imu_t, np.concatenate([[first_bound], frame_t[:-1]]), side="right")
    hi = np.searchsorted(imu_t, frame_t, side="right")
    for k in range(T):
        a, b = lo[k], hi[k]
        m = min(b - a, L)
        if b - a > L:
            a = b - L  # keep the most recent samples
        out_t[k, :m] = imu_t[a : a + m]
        out_g[k, :m] = imu_gyro[a : a + m]
        out_a[k, :m] = imu_acc[a : a + m]
        out_v[k, :m] = True
        if m == 0:
            continue
        tt = np.asarray(imu_t[a : a + m], np.float64)
        if k == 0 and prev_frame_t is None:
            out_dt[k, :m] = -1.0
        elif t_carry is None:
            out_dt[k, 0] = -1.0
            out_dt[k, 1:m] = np.diff(tt)
            t_carry = float(tt[-1])
        else:
            out_dt[k, :m] = np.diff(np.concatenate([[t_carry], tt]))
            t_carry = float(tt[-1])
    return out_t, out_g, out_a, out_v, out_dt


def apply_gravity_init(state: FilterState, gyro_window, acc_window) -> FilterState:
    """Set q0, gyro bias and gravity of one sequence's state from a static
    IMU window (reference initializeGravityAndBias): the one-lane view of
    ``batched_apply_gravity_init``."""
    return drop_lane_axis(batched_apply_gravity_init(
        add_lane_axis(state), np.asarray(gyro_window)[None], np.asarray(acc_window)[None]
    ))


def batched_apply_gravity_init(state: FilterState, gyro_windows, acc_windows) -> FilterState:
    """Per lane of a batched state, q0, gyro bias and gravity from the lane's
    static IMU window: ``gyro_windows`` and ``acc_windows`` (B, n, 3), or
    (n, 3) shared by every lane."""
    dtype, dev = state.P.dtype, state.P.device
    B = state.P.shape[0]
    gyro = torch.as_tensor(np.asarray(gyro_windows), dtype=dtype, device=dev)
    acc = torch.as_tensor(np.asarray(acc_windows), dtype=dtype, device=dev)
    q0, bg, gravity = (x.expand(B, -1).clone() for x in initialize_gravity_bias(gyro, acc))
    imu = state.imu._replace(q=q0, bg=bg, q_null=q0)
    return state._replace(imu=imu, gravity=gravity)


@dataclasses.dataclass
class SequenceResult:
    times: np.ndarray  # (T,)
    positions: np.ndarray  # (T, 3)
    quats_xyzw: np.ndarray  # (T, 4) Hamilton body->world
    num_cams: np.ndarray
    num_tracks: np.ndarray
    final_state: FilterState


def _run_chunk(state: FilterState, frames: FrameFeatures, imu: ImuBatch, params: MsckfParams, cfg, method):
    """``batched_filter_step`` over the T frames of a chunk, one Python step
    per frame: ``frames`` and ``imu`` (B, T, ...).  Returns the state after
    the last frame and the PoseOutput tree (B, T, ...)."""
    outs = []
    for k in range(frames.time.shape[1]):
        state, out = batched_filter_step(
            state, map_tree(lambda x: x[:, k], frames), map_tree(lambda x: x[:, k], imu), params, cfg, method
        )
        outs.append(out)
    return state, type(outs[0])(*(torch.stack(list(x), dim=1) for x in zip(*outs)))


def run_sequence(
    cfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,
    fid: np.ndarray,  # (T, F)
    uv: np.ndarray,  # (T, F, 4)
    valid: np.ndarray,  # (T, F)
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    dtype=torch.float64,
    method: str = "qr",
    chunk: Optional[int] = None,
    state: Optional[FilterState] = None,
    quality: Optional[np.ndarray] = None,  # (T, F) tracking-SNR proxy
    device=None,
) -> SequenceResult:
    """Run the back-end over one sequence of frontend feature frames on
    ``device`` (the CUDA card when None; raises without CUDA unless a
    device is named), one Python step per frame; the per-frame outputs
    come back to the host once every ``chunk`` frames."""
    device = resolve_device(device)
    params = make_params(cfg, calib, dtype, device)
    if state is None:
        state = init_filter_state(cfg, calib, dtype, device)
        # Gravity/bias from the first imu_init_samples (the reference waits
        # for 200 samples before processing frames).
        n0 = min(cfg.imu_init_samples, imu_t.shape[0])
        state = apply_gravity_init(state, imu_gyro[:n0], imu_acc[:n0])
    batches = pack_imu_batches(imu_t, imu_gyro, imu_acc, frame_t, cfg.max_imu_per_frame, device=device)

    def dev(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(device)[None]

    frames = FrameFeatures(
        time=dev(np.asarray(frame_t, np.float64), dtype),
        fid=dev(fid, torch.int32),
        uv=dev(uv, dtype),
        valid=dev(valid, torch.bool),
        quality=None if quality is None else dev(quality, dtype),
    )
    T = frame_t.shape[0]
    chunk = chunk or T
    state = add_lane_axis(state)
    outs = []
    for s0 in range(0, T, chunk):
        sl = slice(s0, min(s0 + chunk, T))
        state, out = _run_chunk(
            state, map_tree(lambda x: x[:, sl], frames), map_tree(lambda x: x[None, sl], batches),
            params, cfg, method,
        )
        outs.append(drop_lane_axis(out))

    def cat(field):
        return torch.cat([getattr(o, field) for o in outs]).cpu().numpy()

    return SequenceResult(
        times=cat("time"),
        positions=cat("p"),
        quats_xyzw=cat("q_xyzw"),
        num_cams=cat("num_cams"),
        num_tracks=cat("num_tracks"),
        final_state=drop_lane_axis(state),
    )
