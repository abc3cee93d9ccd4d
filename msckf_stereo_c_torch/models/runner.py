"""Host-side helpers of the sequence drivers (port of
``msckf_stereo_c_tpu/models/runner.py``): per-frame IMU packing and the
gravity/bias initialization."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .propagation import ImuBatch, initialize_gravity_bias
from .state import FilterState


def pack_imu_batches(
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    frame_t: np.ndarray,
    max_per_frame: int,
    dtype=np.float64,
    prev_frame_t: Optional[float] = None,
    device=None,
) -> ImuBatch:
    """Slice the IMU stream into (T, L) per-frame batches, valid samples
    first.  Frame k gets samples with t in (frame_{k-1}, frame_k] (frame 0:
    everything up to its own time when ``prev_frame_t`` is None).  ``dt``
    carries host-exact float64 deltas chained across frames; -1 asks the
    device to derive the delta from the state clock.  Returned as tensors
    on ``device`` (CPU when None)."""
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

    def t(x):
        return torch.as_tensor(x, device=device)

    return ImuBatch(time=t(out_t), gyro=t(out_g), acc=t(out_a), valid=t(out_v), dt=t(out_dt))


def apply_gravity_init(state: FilterState, gyro_window, acc_window) -> FilterState:
    """Set q0, gyro bias and gravity from a static IMU window (reference
    initializeGravityAndBias)."""
    dtype, dev = state.P.dtype, state.P.device
    gyro = torch.as_tensor(np.asarray(gyro_window), dtype=dtype, device=dev)
    acc = torch.as_tensor(np.asarray(acc_window), dtype=dtype, device=dev)
    q0, bg, gravity = initialize_gravity_bias(gyro, acc)
    imu = state.imu._replace(q=q0, bg=bg, q_null=q0)
    return state._replace(imu=imu, gravity=gravity)
