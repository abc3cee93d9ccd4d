"""Camera-state pruning: redundant-state selection and covariance
compaction (port of ``msckf_stereo_c_tpu/models/pruning.py``)."""
from __future__ import annotations

import torch

from ..utils.lie import rotation_angle
from ..utils.quaternion import jpl_to_rot
from .state import FilterState


def find_redundant_cam_slots(state: FilterState, cfg_rot_thr, cfg_trans_thr, cfg_rate_thr):
    """Two slots to remove (reference findRedundantCamStates): the key state
    is slot n-4; a candidate close to it with good tracking is dropped,
    otherwise the oldest remaining state.  Returns (slot_a, slot_b) sorted,
    as 0-d int64 tensors."""
    n = state.num_cams.long()

    def pose(slot):
        # index_select with a one-element tensor: indexing with a 0-d tensor
        # would read the slot back to the host.
        i = slot.reshape(1)
        return jpl_to_rot(state.cams.q.index_select(0, i)[0]), state.cams.p.index_select(0, i)[0]

    R_key, p_key = pose(n - 4)

    def decide(cand_slot, first_slot):
        R_c, p_c = pose(cand_slot)
        angle = rotation_angle(R_c @ R_key.T)
        dist = torch.linalg.norm(p_c - p_key)
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
    return torch.minimum(chosen0, chosen1), torch.maximum(chosen0, chosen1)


def compact_after_removal(state: FilterState, slot_a, slot_b) -> FilterState:
    """Remove two camera slots and compact the camera arrays, the per-track
    observation columns and the covariance's 6x6 blocks left-wards."""
    M = state.cams.q.shape[0]
    D = state.P.shape[0]
    dev = state.P.device
    n = state.num_cams
    idx = torch.arange(M, device=dev)
    removed = (idx == slot_a) | (idx == slot_b)
    keep = ~removed & (idx < n)
    perm = torch.argsort(torch.where(keep, idx, idx + M))  # kept first, in order
    live = idx < n - 2

    cams = state.cams
    cams = cams._replace(
        q=cams.q[perm],
        p=cams.p[perm],
        q_null=cams.q_null[perm],
        p_null=cams.p_null[perm],
        sid=torch.where(live, cams.sid[perm], -1),
        time=cams.time[perm],
    )
    tracks = state.tracks
    tracks = tracks._replace(
        obs=tracks.obs[:, perm, :],
        obs_valid=tracks.obs_valid[:, perm] & live[None, :],
        quality=tracks.quality[:, perm],
    )

    cam_idx = (21 + 6 * perm[:, None] + torch.arange(6, device=dev)[None, :]).reshape(-1)
    full_idx = torch.cat([torch.arange(21, device=dev), cam_idx])
    P = state.P[full_idx][:, full_idx]
    act = torch.arange(D, device=dev) < 21 + 6 * (n - 2)
    P = torch.where(act[:, None] & act[None, :], P, 0.0)
    return state._replace(cams=cams, num_cams=n - 2, P=P, tracks=tracks)
