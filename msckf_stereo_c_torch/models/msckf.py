"""The stereo MSCKF filter step (port of ``msckf_stereo_c_tpu/models/
msckf.py``, Schur method with Newton-Schulz solves).

propagate -> augment -> observe -> remove lost features (triangulate, gate,
update) -> prune two camera states when the window is full -> publish ->
online reset.  Every phase works on fixed-shape masked tensors.  Of JAX's
two ``lax.cond``s, the online reset is computed and merged with
``torch.where``; the prune branches in Python on one host read per frame,
since it costs a triangulation and an update.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import FilterConfig, StereoCalib, matmul_precision_scope
from ..utils.chi2 import chi2_p95_table
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .augmentation import add_feature_observations, augment_state
from .propagation import ImuBatch, propagate
from .pruning import compact_after_removal, find_redundant_cam_slots
from .state import FilterState, continuous_noise_cov, initial_cov_diag
from .triangulation import check_motion_tracks, triangulate_tracks
from .update import (
    cam_cov_blocks,
    measurement_update_schur,
    measurement_update_schur_compact,
    schur_gating,
    schur_gating_compact,
    track_blocks,
)


class FrameFeatures(NamedTuple):
    """Per-frame output of the frontend."""

    time: torch.Tensor  # ()
    fid: torch.Tensor  # (F,) int32
    uv: torch.Tensor  # (F, 4) normalized [u0, v0, u1, v1]
    valid: torch.Tensor  # (F,) bool
    quality: Optional[torch.Tensor] = None  # (F,) tracking-SNR proxy


class MsckfParams(NamedTuple):
    """Calibration and tables, as tensors on the run's device."""

    R_c0_c1: torch.Tensor
    t_c0_c1: torch.Tensor
    Q_imu: torch.Tensor
    chi2_table: torch.Tensor
    sigma2: torch.Tensor
    init_cov_diag: torch.Tensor
    T_body_imu_R: torch.Tensor
    rotation_threshold: torch.Tensor
    translation_threshold: torch.Tensor
    tracking_rate_threshold: torch.Tensor
    feature_translation_threshold: torch.Tensor
    position_std_threshold: torch.Tensor


class PoseOutput(NamedTuple):
    time: torch.Tensor
    p: torch.Tensor  # (3,) body position in world
    q_xyzw: torch.Tensor  # (4,) Hamilton body->world quaternion
    p_cov: torch.Tensor  # (3,3) body-frame position covariance
    num_cams: torch.Tensor
    num_tracks: torch.Tensor
    tracking_rate: torch.Tensor


def check_supported(cfg: FilterConfig, method: str) -> None:
    """Raise NotImplementedError for a filter configuration not ported yet."""
    unsupported = [
        ("method", method != "schur"),
        ("ns_iters", cfg.ns_iters == 0),
    ]
    for name, bad in unsupported:
        if bad:
            value = method if name == "method" else getattr(cfg, name)
            raise NotImplementedError(
                f"the PyTorch port covers the Schur filter with Newton-Schulz "
                f"solves only; {name}={value!r} is not ported yet"
            )


def make_params(cfg: FilterConfig, calib: StereoCalib, dtype=torch.float64, device=None) -> MsckfParams:
    T01 = calib.T_cam0_cam1_mat()
    Tib = np.asarray(calib.T_imu_body, dtype=np.float64).reshape(4, 4)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return MsckfParams(
        R_c0_c1=t(T01[:3, :3]),
        t_c0_c1=t(T01[:3, 3]),
        Q_imu=continuous_noise_cov(cfg, dtype, device),
        chi2_table=t(chi2_p95_table(99)),
        sigma2=t(cfg.observation_noise_var),
        init_cov_diag=t(initial_cov_diag(cfg, cfg.state_dim)),
        T_body_imu_R=t(Tib[:3, :3].T),
        rotation_threshold=t(cfg.rotation_threshold),
        translation_threshold=t(cfg.translation_threshold),
        tracking_rate_threshold=t(cfg.tracking_rate_threshold),
        feature_translation_threshold=t(cfg.feature_translation_threshold),
        position_std_threshold=t(cfg.position_std_threshold),
    )


def _snr_weights(quality: torch.Tensor, obs_mask: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """Per-track EKF weight w = sigma2_base / sigma2_track of the
    SNR-adaptive observation noise (FilterConfig.noise_adaptive).

    ``quality`` (Kc, Ms) per-observation template min-eig (0 = unknown),
    ``obs_mask`` the observations that belong to the track.  The track's
    noise variance inflates by clip(ref / mean quality, 1, cap); a track of
    unknown quality keeps the base noise.  Returns (Kc,) weights in (0, 1]."""
    q = torch.where(obs_mask & (quality > 0), quality, torch.zeros_like(quality))
    cnt = torch.sum(q > 0, dim=1)
    qmean = torch.sum(q, dim=1) / torch.clamp(cnt, min=1).to(q.dtype)
    infl = torch.where(
        qmean > 0,
        torch.clamp(cfg.noise_snr_ref / torch.clamp(qmean, min=1e-12), 1.0, cfg.noise_inflation_cap),
        torch.ones_like(qmean),
    )
    return 1.0 / infl


def _gate_and_update(
    state: FilterState, params: MsckfParams, pos, obs, obs_mask, use, dof,
    cam_idx=None, ns_iters: int = 10, w=None,
) -> FilterState:
    """Chi-square gate and Schur EKF update over the selected tracks;
    ``cam_idx`` runs the whole gate and update camera-compacted.  ``w``
    (K,), from ``_snr_weights``, scales each track's Jacobian blocks and
    residuals by sqrt(w), which makes the base-noise formulas the
    per-track-noise gate and update exactly."""
    cams = state.cams
    if cam_idx is not None:
        cams = cams._replace(
            q=cams.q[cam_idx], p=cams.p[cam_idx],
            q_null=cams.q_null[cam_idx], p_null=cams.p_null[cam_idx],
        )
    blocks = track_blocks(pos, obs, obs_mask, cams, state.gravity, params.R_c0_c1, params.t_c0_c1)
    if w is not None:
        sw = torch.sqrt(w).to(blocks.H_x.dtype)
        blocks = blocks._replace(
            H_x=blocks.H_x * sw[:, None, None, None],
            H_f=blocks.H_f * sw[:, None, None, None],
            r=blocks.r * sw[:, None, None],
        )
    if cam_idx is not None:
        Pc = cam_cov_blocks(state.P, cam_idx)
        gamma = schur_gating_compact(blocks, Pc, params.sigma2, ns_iters)
        use = use & (gamma < params.chi2_table[dof])
        return measurement_update_schur_compact(state, blocks, use, params.sigma2, cam_idx, ns_iters)
    gamma = schur_gating(blocks, state.P, params.sigma2, ns_iters)
    use = use & (gamma < params.chi2_table[dof])
    return measurement_update_schur(state, blocks, use, params.sigma2, ns_iters)


def _compact_candidates(candidates: torch.Tensor, max_update: int) -> torch.Tensor:
    """Stable indices of at most ``max_update`` candidates, selected first."""
    K = candidates.shape[0]
    if not max_update or max_update >= K:
        return torch.arange(K, device=candidates.device)
    return torch.argsort((~candidates).to(torch.int8), stable=True)[:max_update]


def _triangulated(state: FilterState, params: MsckfParams, idx):
    """Motion check and triangulation of the compacted tracks ``idx``;
    initialized tracks keep their stored position."""
    tracks = state.tracks
    obs_c = tracks.obs[idx]
    obs_valid_c = tracks.obs_valid[idx]
    initialized_c = tracks.initialized[idx]
    motion_ok = check_motion_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p, params.feature_translation_threshold
    )
    tri = triangulate_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p, params.R_c0_c1, params.t_c0_c1
    )
    init_ok = torch.where(initialized_c, True, motion_ok & tri.valid)
    pos = torch.where(initialized_c[:, None], tracks.pos[idx], tri.pos_w)
    return obs_c, obs_valid_c, initialized_c, motion_ok & tri.valid, init_ok, pos


def _lost_candidates(state: FilterState, params: MsckfParams, max_update: int = 0):
    """Select and triangulate the tracks that lost tracking this frame."""
    tracks = state.tracks
    M = tracks.obs_valid.shape[1]
    active = tracks.fid >= 0
    newest = torch.clamp(state.num_cams.long() - 1, min=0).reshape(1)
    observed_now = tracks.obs_valid.index_select(1, newest)[:, 0] & (state.num_cams > 0)
    lost = active & ~observed_now
    n_obs = torch.sum(tracks.obs_valid, dim=1)
    drop_only = lost & (n_obs < 3)
    candidates = lost & (n_obs >= 3)

    idx = _compact_candidates(candidates, max_update)
    obs_c, obs_valid_c, _, _, init_ok, pos = _triangulated(state, params, idx)
    use = candidates[idx] & init_ok
    dof = torch.clamp(n_obs[idx] - 1, 1, 99)
    return idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates


def _remove_lost_features(state: FilterState, params: MsckfParams, cfg: FilterConfig) -> FilterState:
    """Triangulate and update with the tracks that lost tracking this frame
    (reference removeLostFeatures)."""
    idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates = _lost_candidates(
        state, params, cfg.max_update_tracks
    )
    w = _snr_weights(state.tracks.quality[idx], obs_valid_c, cfg) if cfg.noise_adaptive else None
    state = _gate_and_update(
        state, params, pos, obs_c, obs_valid_c & use[:, None], use, dof, ns_iters=cfg.ns_iters, w=w
    )
    gone = drop_only | candidates
    tracks = state.tracks._replace(
        fid=torch.where(gone, -1, state.tracks.fid),
        obs_valid=state.tracks.obs_valid & ~gone[:, None],
        initialized=state.tracks.initialized & ~gone,
    )
    return state._replace(tracks=tracks)


def _prune_cam_states(state: FilterState, params: MsckfParams, cfg: FilterConfig) -> FilterState:
    """Marginalize two redundant camera states (reference
    pruneCamStateBuffer), gate and update camera-compacted to the two
    slots."""
    tracks = state.tracks
    K, M = tracks.obs_valid.shape
    dev = state.P.device
    slot_a, slot_b = find_redundant_cam_slots(
        state, params.rotation_threshold, params.translation_threshold,
        params.tracking_rate_threshold,
    )
    cam_idx = torch.stack([slot_a, slot_b])
    involved = tracks.obs_valid[:, cam_idx].to(torch.int32).sum(dim=1)
    ar = torch.arange(M, device=dev)[None, :]
    involved_mask = ((ar == slot_a) | (ar == slot_b)) & tracks.obs_valid

    update_cand = (tracks.fid >= 0) & (involved >= 2)
    idx = _compact_candidates(update_cand, cfg.max_update_tracks)
    obs_k, _, initialized_k, tri_ok, init_ok, pos = _triangulated(state, params, idx)
    cand_k = update_cand[idx]
    newly_init = cand_k & ~initialized_k & tri_ok
    use = cand_k & init_ok
    dof = torch.clamp(involved[idx], 1, 99)
    mask_c = (involved_mask[idx] & use[:, None])[:, cam_idx]
    # The weight comes from the observations this update consumes (the two
    # pruned slots).
    w = _snr_weights(tracks.quality[idx], involved_mask[idx], cfg) if cfg.noise_adaptive else None
    state = _gate_and_update(
        state, params, pos, obs_k[:, cam_idx], mask_c, use, dof,
        cam_idx=cam_idx, ns_iters=cfg.ns_iters, w=w,
    )

    # Persist positions of tracks initialized here; delete the involved
    # observations from every track.
    t = state.tracks
    tracks = t._replace(
        pos=t.pos.index_copy(0, idx, torch.where(newly_init[:, None], pos, t.pos[idx])),
        initialized=t.initialized.index_copy(0, idx, t.initialized[idx] | newly_init),
        obs_valid=t.obs_valid & ~involved_mask,
    )
    state = state._replace(tracks=tracks)
    return compact_after_removal(state, slot_a, slot_b)


def _online_reset(state: FilterState, params: MsckfParams) -> FilterState:
    """Uncertainty watchdog (reference onlineReset), merged with
    ``torch.where`` so it needs no host read."""
    thr = params.position_std_threshold
    stds_ok = torch.all(torch.sqrt(torch.diagonal(state.P)[12:15]) < thr)
    reset = (thr > 0) & ~stds_ok
    t = state.tracks
    tracks = t._replace(
        fid=torch.where(reset, -1, t.fid),
        obs_valid=t.obs_valid & ~reset,
        initialized=t.initialized & ~reset,
    )
    return state._replace(
        num_cams=torch.where(reset, 0, state.num_cams),
        P=torch.where(reset, torch.diag(params.init_cov_diag), state.P),
        tracks=tracks,
        online_reset_count=state.online_reset_count + reset.to(torch.int32),
    )


def _publish(state: FilterState, time, params: MsckfParams) -> PoseOutput:
    """Body pose T_b_w = T_imu_body T_i_w T_imu_body^-1 and the body-frame
    position covariance."""
    R_bi = params.T_body_imu_R
    R_i_w = jpl_to_rot(state.imu.q).T
    R_b_w = R_bi @ R_i_w @ R_bi.T
    return PoseOutput(
        time=time,
        p=R_bi @ state.imu.p,
        q_xyzw=rot_to_jpl(R_b_w.T),
        p_cov=R_bi @ state.P[12:15, 12:15] @ R_bi.T,
        num_cams=state.num_cams,
        num_tracks=torch.sum(state.tracks.fid >= 0),
        tracking_rate=state.tracking_rate,
    )


def filter_step(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "schur",
):
    """One frame of the back-end.  Returns (state, PoseOutput)."""
    check_supported(cfg, method)
    with matmul_precision_scope(cfg.matmul_precision):
        first = state.next_sid == 0
        state = state._replace(
            imu=state.imu._replace(time=torch.where(first, frame.time, state.imu.time))
        )
        state = propagate(state, imu, params.Q_imu)
        state = augment_state(state, frame.time)
        quality = frame.quality
        if quality is None:
            quality = torch.zeros_like(frame.uv[:, 0])
        state = add_feature_observations(state, frame.fid, frame.uv, frame.valid, quality)
        state = _remove_lost_features(state, params, cfg)
        if bool(state.num_cams >= cfg.max_cam_state_size):  # one host read per frame
            state = _prune_cam_states(state, params, cfg)
        out = _publish(state, frame.time, params)
        state = _online_reset(state, params)
        return state, out
