# Frozen copy of msckf_stereo_c_torch/models/state.py at commit 50013dad8c92.
"""Fixed-shape filter state (port of ``msckf_stereo_c_tpu/models/state.py``).

Camera states live in a compaction queue of ``M = max_cam_state_size`` slots
(oldest first); the (21+6M, 21+6M) covariance keeps zero rows and columns
beyond the active count; feature tracks live in a pool of ``max_tracks``
slots with (M, 4) observations aligned to the camera slots.  Error-state
layout: [0:3 dtheta, 3:6 d_bg, 6:9 dv, 9:12 d_ba, 12:15 dp, 15:18
dtheta_extr, 18:21 dt_extr], then 6 per camera slot [dtheta_c, dp_c].
The shapes below are one sequence's; a batched state (``utils/lanes.py``)
carries a leading lane axis B on every tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FilterConfig, StereoCalib
from ..utils.quaternion import quat_identity


class ImuState(NamedTuple):
    q: torch.Tensor  # (4,) JPL world->IMU
    bg: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    p: torch.Tensor  # (3,)
    R_imu_cam0: torch.Tensor  # (3,3) rotates IMU-frame vectors to cam0 frame
    t_cam0_imu: torch.Tensor  # (3,) cam0 position in IMU frame
    q_null: torch.Tensor  # (4,) observability-constrained shadow states
    v_null: torch.Tensor  # (3,)
    p_null: torch.Tensor  # (3,)
    time: torch.Tensor  # () seconds


class CamStates(NamedTuple):
    q: torch.Tensor  # (M, 4) JPL world->cam0
    p: torch.Tensor  # (M, 3) cam0 position in world
    q_null: torch.Tensor  # (M, 4)
    p_null: torch.Tensor  # (M, 3)
    sid: torch.Tensor  # (M,) int32 state id
    time: torch.Tensor  # (M,)


class TrackMap(NamedTuple):
    fid: torch.Tensor  # (K,) int32 feature id; -1 = free slot
    obs: torch.Tensor  # (K, M, 4) normalized [u0, v0, u1, v1]
    obs_valid: torch.Tensor  # (K, M) bool
    pos: torch.Tensor  # (K, 3) triangulated world position
    initialized: torch.Tensor  # (K,) bool
    quality: torch.Tensor  # (K, M) tracking-SNR proxy per observation


class FilterState(NamedTuple):
    imu: ImuState
    cams: CamStates
    num_cams: torch.Tensor  # () int32 active camera slots
    P: torch.Tensor  # (D, D) error covariance, D = 21 + 6M
    tracks: TrackMap
    gravity: torch.Tensor  # (3,) world gravity (0, 0, -g)
    tracking_rate: torch.Tensor  # ()
    next_sid: torch.Tensor  # () int32 camera state id counter
    online_reset_count: torch.Tensor  # () int32


def init_filter_state(
    cfg: FilterConfig, calib: StereoCalib, dtype=torch.float64, device=None
) -> FilterState:
    """The initial state (reference loadParameters)."""
    M = cfg.max_cam_state_size
    K = cfg.max_tracks
    D = cfg.state_dim
    T_ci = calib.cam0.T_cam_imu_mat()

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    q0 = quat_identity(dtype, device)
    imu = ImuState(
        q=q0,
        bg=z(3),
        v=t(cfg.initial_velocity),
        ba=z(3),
        p=z(3),
        R_imu_cam0=t(T_ci[:3, :3]),
        t_cam0_imu=t(-T_ci[:3, :3].T @ T_ci[:3, 3]),
        q_null=q0.clone(),
        v_null=t(cfg.initial_velocity),
        p_null=z(3),
        time=z(),
    )
    cams = CamStates(
        q=q0.repeat(M, 1),
        p=z(M, 3),
        q_null=q0.repeat(M, 1),
        p_null=z(M, 3),
        sid=-torch.ones((M,), dtype=torch.int32, device=device),
        time=z(M),
    )
    tracks = TrackMap(
        fid=-torch.ones((K,), dtype=torch.int32, device=device),
        obs=z(K, M, 4),
        obs_valid=z(K, M, dt=torch.bool),
        pos=z(K, 3),
        initialized=z(K, dt=torch.bool),
        quality=z(K, M),
    )
    return FilterState(
        imu=imu,
        cams=cams,
        num_cams=z(dt=torch.int32),
        P=torch.diag(t(initial_cov_diag(cfg, D))),
        tracks=tracks,
        gravity=t([0.0, 0.0, -9.81]),
        tracking_rate=z(),
        next_sid=z(dt=torch.int32),
        online_reset_count=z(dt=torch.int32),
    )


def initial_cov_diag(cfg: FilterConfig, D: int) -> np.ndarray:
    """Initial covariance diagonal: zero orientation and position
    uncertainty; velocity, bias and extrinsic blocks from the config."""
    diag = np.zeros(D, dtype=np.float64)
    diag[3:6] = cfg.initial_cov_gyro_bias
    diag[6:9] = cfg.initial_cov_velocity
    diag[9:12] = cfg.initial_cov_acc_bias
    diag[15:18] = cfg.initial_cov_extrinsic_rotation
    diag[18:21] = cfg.initial_cov_extrinsic_translation
    return diag


def continuous_noise_cov(cfg: FilterConfig, dtype=torch.float64, device=None) -> torch.Tensor:
    """12x12 continuous-time process noise."""
    diag = np.concatenate(
        [
            np.full(3, cfg.gyro_noise_var),
            np.full(3, cfg.gyro_bias_noise_var),
            np.full(3, cfg.acc_noise_var),
            np.full(3, cfg.acc_bias_noise_var),
        ]
    )
    return torch.diag(torch.as_tensor(diag, dtype=dtype, device=device))


def active_cam_mask(num_cams: torch.Tensor, M: int) -> torch.Tensor:
    """(..., M) bool mask of active camera slots."""
    return torch.arange(M, device=num_cams.device) < num_cams[..., None]


def active_state_mask(num_cams: torch.Tensor, D: int) -> torch.Tensor:
    """(..., D) bool mask of active error-state entries."""
    return torch.arange(D, device=num_cams.device) < 21 + 6 * num_cams[..., None]
