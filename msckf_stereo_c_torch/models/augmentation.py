"""Camera-state augmentation and feature-observation bookkeeping (port of
``msckf_stereo_c_tpu/models/augmentation.py``).

The new camera pose goes to slot ``num_cams`` and the covariance's new
6-row/column band is written in place of ``conservative_resize``; incoming
features are matched to pool tracks with an equality matrix and new tracks
take free slots by a rank/cumsum assignment.  Slot indices stay tensors, so
nothing here reads back to the host.
"""
from __future__ import annotations

import torch

from ..utils.lie import skew
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .state import FilterState


def augment_state(state: FilterState, time: torch.Tensor) -> FilterState:
    """Append a camera state derived from the current IMU pose and
    extrinsics."""
    imu = state.imu
    dtype = state.P.dtype
    dev = state.P.device
    n = state.num_cams.long().reshape(1)

    R_i_c = imu.R_imu_cam0
    t_c_i = imu.t_cam0_imu
    R_w_i = jpl_to_rot(imu.q)
    R_w_c = R_i_c @ R_w_i
    t_c_w = imu.p + R_w_i.T @ t_c_i
    q_cam = rot_to_jpl(R_w_c)

    cams = state.cams
    cams = cams._replace(
        q=cams.q.index_copy(0, n, q_cam[None]),
        p=cams.p.index_copy(0, n, t_c_w[None]),
        q_null=cams.q_null.index_copy(0, n, q_cam[None]),
        p_null=cams.p_null.index_copy(0, n, t_c_w[None]),
        sid=cams.sid.index_copy(0, n, state.next_sid.reshape(1)),
        time=cams.time.index_copy(0, n, time.to(dtype).reshape(1)),
    )

    # Jacobian of the new camera error state w.r.t. the 21-dof IMU state.
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((6, 21), dtype=dtype, device=dev)
    J[0:3, 0:3] = R_i_c
    J[0:3, 15:18] = eye3
    J[3:6, 0:3] = skew(R_w_i.T @ t_c_i)
    J[3:6, 12:15] = eye3
    J[3:6, 18:21] = eye3

    band = J @ state.P[:21, :]  # (6, D)
    block = J @ state.P[:21, :21] @ J.T
    rows = 21 + 6 * n + torch.arange(6, device=dev)
    P = state.P.index_copy(0, rows, band)
    P = P.index_copy(1, rows, band.T)
    P = P.index_put((rows[:, None], rows[None, :]), block)
    P = 0.5 * (P + P.T)

    # The new slot starts with no feature observations.
    tracks = state.tracks._replace(obs_valid=state.tracks.obs_valid.index_fill(1, n, False))
    return state._replace(
        cams=cams,
        num_cams=state.num_cams + 1,
        P=P,
        tracks=tracks,
        next_sid=state.next_sid + 1,
    )


def add_feature_observations(
    state: FilterState,
    fid: torch.Tensor,  # (F,) int32 feature ids from the frontend
    uv: torch.Tensor,  # (F, 4) normalized [u0, v0, u1, v1]
    valid: torch.Tensor,  # (F,) bool
    quality: torch.Tensor,  # (F,) tracking-SNR proxy (0 = unknown)
) -> FilterState:
    """Upsert this frame's stereo observations into the track pool and
    compute the tracking rate (reference addFeatureObservations)."""
    tracks = state.tracks
    K, M = tracks.obs_valid.shape
    F = fid.shape[0]
    dev = fid.device
    slot = (state.num_cams.long() - 1).reshape(1)
    quality = quality.to(tracks.quality.dtype)

    pool_active = tracks.fid >= 0
    curr_feature_num = torch.sum(pool_active)

    # Match incoming features to existing tracks.
    eq = (tracks.fid[:, None] == fid[None, :]) & valid[None, :] & pool_active[:, None]
    matched_track = torch.any(eq, dim=1)
    matched_feat = torch.any(eq, dim=0)
    src = torch.argmax(eq.to(torch.int8), dim=1)

    def set_slot(x, new):
        """x[:, slot] = where(matched_track, new, x[:, slot])."""
        cur = x.index_select(1, slot)[:, 0]
        mt = matched_track.reshape((K,) + (1,) * (cur.dim() - 1))
        return x.index_copy(1, slot, torch.where(mt, new, cur)[:, None])

    obs = set_slot(tracks.obs, uv[src])
    obs_valid = set_slot(tracks.obs_valid, torch.ones_like(matched_track))
    qual = set_slot(tracks.quality, quality[src])

    # Allocate new tracks for unmatched features into free slots; index K
    # is a dump row that is sliced off.
    is_new = valid & ~matched_feat
    free = ~pool_active
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    n_free = torch.sum(free)
    slot_of_rank = torch.full((K + 1,), K, dtype=torch.int64, device=dev)
    slot_of_rank = slot_of_rank.index_put(
        (torch.where(free, free_rank, K),), torch.arange(K, device=dev)
    )[:K]
    target = torch.where(
        is_new & (new_rank < n_free), slot_of_rank[torch.clamp(new_rank, 0, K - 1)], K
    )

    def scatter(x, val):
        pad = torch.cat([x, x[:1]], dim=0)
        return pad.index_put((target,), val)[:K]

    def scatter_slot(x, val):
        pad = torch.cat([x, x[:1]], dim=0)
        return pad.index_put((target, slot.expand(F)), val)[:K]

    new_fid = scatter(tracks.fid, fid.to(tracks.fid.dtype))
    obs = scatter_slot(obs, uv.to(obs.dtype))
    obs_valid = scatter_slot(obs_valid, torch.ones_like(valid))
    qual = scatter_slot(qual, quality)
    initialized = scatter(tracks.initialized, torch.zeros_like(valid))
    pos = scatter(tracks.pos, torch.zeros((F, 3), dtype=tracks.pos.dtype, device=dev))

    tracked_num = torch.sum(matched_feat)
    dtype = state.P.dtype
    tracking_rate = tracked_num.to(dtype) / torch.clamp(curr_feature_num.to(dtype), min=1e-5)

    tracks = tracks._replace(
        fid=new_fid, obs=obs, obs_valid=obs_valid, initialized=initialized, pos=pos,
        quality=qual,
    )
    return state._replace(tracks=tracks, tracking_rate=tracking_rate)
