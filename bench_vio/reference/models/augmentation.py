# Frozen copy of msckf_stereo_c_torch/models/augmentation.py at commit 50013dad8c92.
"""Camera-state augmentation and feature-observation bookkeeping (port of
``msckf_stereo_c_tpu/models/augmentation.py``).

The new camera pose goes to slot ``num_cams`` and the covariance's new
6-row/column band is written in place of ``conservative_resize``; incoming
features are matched to pool tracks with an equality matrix and new tracks
take free slots by a rank/cumsum assignment.  Slot indices stay tensors, so
nothing here reads back to the host.  States carry a leading lane axis;
each lane writes its own slot.
"""
from __future__ import annotations

import torch

from ..utils.lanes import scatter_drop, take
from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .state import FilterState


def augment_state(state: FilterState, time: torch.Tensor) -> FilterState:
    """Append a camera state derived from the current IMU pose and
    extrinsics to every lane (``state`` with a leading lane axis B, ``time``
    (B,)), at each lane's slot ``num_cams``."""
    imu = state.imu
    dtype = state.P.dtype
    dev = state.P.device
    B, M = state.cams.sid.shape
    n = state.num_cams.long()
    at_n = torch.arange(M, device=dev)[None, :] == n[:, None]  # (B, M)

    R_i_c = imu.R_imu_cam0
    t_c_i = imu.t_cam0_imu
    R_w_i = jpl_to_rot(imu.q)
    R_w_c = R_i_c @ R_w_i
    t_i_c = (R_w_i.transpose(-1, -2) @ t_c_i[..., None])[..., 0]
    t_c_w = imu.p + t_i_c
    q_cam = rot_to_jpl(R_w_c)

    def put(x, v):
        return torch.where(at_n.reshape(at_n.shape + (1,) * (x.dim() - 2)), v[:, None], x)

    cams = state.cams
    cams = cams._replace(
        q=put(cams.q, q_cam),
        p=put(cams.p, t_c_w),
        q_null=put(cams.q_null, q_cam),
        p_null=put(cams.p_null, t_c_w),
        sid=put(cams.sid, state.next_sid),
        time=put(cams.time, time.to(dtype)),
    )

    # Jacobian of the new camera error state w.r.t. the 21-dof IMU state.
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((B, 6, 21), dtype=dtype, device=dev)
    J[:, 0:3, 0:3] = R_i_c
    J[:, 0:3, 15:18] = eye3
    J[:, 3:6, 0:3] = skew(t_i_c)
    J[:, 3:6, 12:15] = eye3
    J[:, 3:6, 18:21] = eye3

    D = state.P.shape[-1]
    band = J @ state.P[:, :21, :]  # (B, 6, D)
    block = J @ state.P[:, :21, :21] @ J.transpose(-1, -2)
    rows = 21 + 6 * n[:, None] + torch.arange(6, device=dev)  # (B, 6)
    P = state.P.scatter(1, rows[:, :, None].expand(B, 6, D), band)
    P = P.scatter(2, rows[:, None, :].expand(B, D, 6), band.transpose(1, 2))
    lanes = torch.arange(B, device=dev)[:, None, None]
    P = P.index_put((lanes, rows[:, :, None], rows[:, None, :]), block)
    P = 0.5 * (P + P.transpose(-1, -2))

    # The new slot starts with no feature observations.
    tracks = state.tracks._replace(obs_valid=state.tracks.obs_valid & ~at_n[:, None, :])
    return state._replace(
        cams=cams,
        num_cams=state.num_cams + 1,
        P=P,
        tracks=tracks,
        next_sid=state.next_sid + 1,
    )


def add_feature_observations(
    state: FilterState,
    fid: torch.Tensor,  # (B, F) int32 feature ids from the frontend
    uv: torch.Tensor,  # (B, F, 4) normalized [u0, v0, u1, v1]
    valid: torch.Tensor,  # (B, F) bool
    quality: torch.Tensor,  # (B, F) tracking-SNR proxy (0 = unknown)
) -> FilterState:
    """Upsert each lane's stereo observations of this frame into its track
    pool and compute its tracking rate (reference
    addFeatureObservations)."""
    tracks = state.tracks
    B, K, M = tracks.obs_valid.shape
    F = fid.shape[1]
    dev = fid.device
    slot = state.num_cams.long() - 1
    at_slot = torch.arange(M, device=dev)[None, :] == slot[:, None]  # (B, M)
    quality = quality.to(tracks.quality.dtype)

    pool_active = tracks.fid >= 0
    curr_feature_num = torch.sum(pool_active, dim=1)

    # Match incoming features to existing tracks.
    eq = (tracks.fid[:, :, None] == fid[:, None, :]) & valid[:, None, :] & pool_active[:, :, None]
    matched_track = torch.any(eq, dim=2)
    matched_feat = torch.any(eq, dim=1)
    src = torch.argmax(eq.to(torch.int8), dim=2)

    def set_slot(x, new):
        """x[:, :, slot] = where(matched_track, new, x[:, :, slot])."""
        m = (at_slot[:, None, :] & matched_track[:, :, None]).reshape((B, K, M) + (1,) * (x.dim() - 3))
        return torch.where(m, new[:, :, None], x)

    obs = set_slot(tracks.obs, take(uv, src))
    obs_valid = tracks.obs_valid | (at_slot[:, None, :] & matched_track[:, :, None])
    qual = set_slot(tracks.quality, take(quality, src))

    # Allocate new tracks for unmatched features into free slots; index K
    # is a dump row that is sliced off.
    is_new = valid & ~matched_feat
    free = ~pool_active
    free_rank = torch.cumsum(free.to(torch.int64), 1) - 1
    new_rank = torch.cumsum(is_new.to(torch.int64), 1) - 1
    n_free = torch.sum(free, dim=1, keepdim=True)
    slot_of_rank = scatter_drop(
        torch.full((B, K), K, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, K),
        torch.arange(K, device=dev).expand(B, K),
    )
    target = torch.where(
        is_new & (new_rank < n_free),
        torch.take_along_dim(slot_of_rank, torch.clamp(new_rank, 0, K - 1), dim=1),
        K,
    )
    lanes = torch.arange(B, device=dev)[:, None].expand(B, F)

    def scatter_slot(x, val):
        pad = torch.cat([x, x[:, :1]], dim=1)
        return pad.index_put((lanes, target, slot[:, None].expand(B, F)), val)[:, :K]

    new_fid = scatter_drop(tracks.fid, target, fid.to(tracks.fid.dtype))
    obs = scatter_slot(obs, uv.to(obs.dtype))
    obs_valid = scatter_slot(obs_valid, torch.ones_like(valid))
    qual = scatter_slot(qual, quality)
    initialized = scatter_drop(tracks.initialized, target, False)
    pos = scatter_drop(tracks.pos, target, 0.0)

    tracked_num = torch.sum(matched_feat, dim=1)
    dtype = state.P.dtype
    tracking_rate = tracked_num.to(dtype) / torch.clamp(curr_feature_num.to(dtype), min=1e-5)

    tracks = tracks._replace(
        fid=new_fid, obs=obs, obs_valid=obs_valid, initialized=initialized, pos=pos,
        quality=qual,
    )
    return state._replace(tracks=tracks, tracking_rate=tracking_rate)
