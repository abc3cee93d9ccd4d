"""Camera-state pruning: redundant-state selection and covariance
compaction (port of ``msckf_stereo_c_tpu/models/pruning.py``), per lane of
a state with a leading sequence axis B."""
from __future__ import annotations

import torch

from ..utils.lanes import at_slot, take
from ..utils.lie import rotation_angle
from ..utils.quaternion import jpl_to_rot
from .state import FilterState


def find_redundant_cam_slots(state: FilterState, cfg_rot_thr, cfg_trans_thr, cfg_rate_thr):
    """Two slots to remove per lane (reference findRedundantCamStates): the
    key state is slot n-4; a candidate close to it with good tracking is
    dropped, otherwise the oldest remaining state.  Returns (slot_a,
    slot_b) sorted, each (B,) int64.  Slots are clamped into the window, so
    a lane with fewer than four states gives in-range slots that its caller
    discards; a lane with a full window never reaches the clamps."""
    M = state.cams.q.shape[1]
    n = state.num_cams.long()

    def pose(slot):
        i = torch.clamp(slot, 0, M - 1)
        return jpl_to_rot(at_slot(state.cams.q, i)), at_slot(state.cams.p, i)

    R_key, p_key = pose(n - 4)

    def decide(cand_slot, first_slot):
        R_c, p_c = pose(cand_slot)
        angle = rotation_angle(R_c @ R_key.transpose(-1, -2))
        dist = torch.linalg.norm(p_c - p_key, dim=-1)
        near = (
            (angle < cfg_rot_thr)
            & (dist < cfg_trans_thr)
            & (state.tracking_rate > cfg_rate_thr)
        )
        return torch.where(near, cand_slot, first_slot), near

    cand0 = n - 3
    first0 = torch.zeros_like(n)
    chosen0, near0 = decide(cand0, first0)
    cand1 = torch.where(near0, cand0 + 1, cand0)
    first1 = torch.where(near0, first0, first0 + 1)
    chosen1, _ = decide(cand1, first1)
    lo = torch.clamp(torch.minimum(chosen0, chosen1), 0, M - 1)
    return lo, torch.clamp(torch.maximum(chosen0, chosen1), 0, M - 1)


def compact_after_removal(state: FilterState, slot_a, slot_b) -> FilterState:
    """Remove two camera slots per lane and compact the camera arrays, the
    per-track observation columns and the covariance's 6x6 blocks
    left-wards."""
    B, M = state.cams.sid.shape
    D = state.P.shape[-1]
    dev = state.P.device
    n = state.num_cams[:, None]
    idx = torch.arange(M, device=dev)[None, :]
    removed = (idx == slot_a[:, None]) | (idx == slot_b[:, None])
    keep = ~removed & (idx < n)
    perm = torch.argsort(torch.where(keep, idx, idx + M), dim=1)  # kept first, in order
    live = idx < n - 2

    cams = state.cams
    cams = cams._replace(
        q=take(cams.q, perm),
        p=take(cams.p, perm),
        q_null=take(cams.q_null, perm),
        p_null=take(cams.p_null, perm),
        sid=torch.where(live, take(cams.sid, perm), -1),
        time=take(cams.time, perm),
    )
    tracks = state.tracks
    tracks = tracks._replace(
        obs=torch.take_along_dim(tracks.obs, perm[:, None, :, None], dim=2),
        obs_valid=torch.take_along_dim(tracks.obs_valid, perm[:, None, :], dim=2) & live[:, None, :],
        quality=torch.take_along_dim(tracks.quality, perm[:, None, :], dim=2),
    )

    cam_idx = (21 + 6 * perm[..., None] + torch.arange(6, device=dev)).reshape(B, 6 * M)
    full_idx = torch.cat([torch.arange(21, device=dev).expand(B, 21), cam_idx], dim=1)
    P = torch.take_along_dim(state.P, full_idx[:, :, None], dim=1)
    P = torch.take_along_dim(P, full_idx[:, None, :], dim=2)
    act = torch.arange(D, device=dev)[None, :] < 21 + 6 * (n - 2)
    P = torch.where(act[:, :, None] & act[:, None, :], P, 0.0)
    return state._replace(cams=cams, num_cams=state.num_cams - 2, P=P, tracks=tracks)
