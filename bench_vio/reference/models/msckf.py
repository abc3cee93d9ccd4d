# Frozen copy of msckf_stereo_c_torch/models/msckf.py at commit 50013dad8c92 (one docstring word changed).
"""The stereo MSCKF filter step (port of ``msckf_stereo_c_tpu/models/
msckf.py``): methods 'qr', 'cholesky' and 'schur', exact solves
(``ns_iters == 0``) or Newton-Schulz ones, and the differential-debug dump
``filter_internals``.

propagate -> augment -> observe -> remove lost features (triangulate, gate,
update) -> prune two camera states when the window is full -> publish ->
online reset.  Every phase works on fixed-shape masked tensors with a
leading sequence lane axis B (``batched_filter_step``; ``filter_step`` is
its one-lane view).  Of JAX's two ``lax.cond``s, the online reset is
computed and merged with ``torch.where``; the prune branches in Python on
one host read per frame for all lanes, since it costs a triangulation and
an update, and is merged per lane with ``torch.where``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import FilterConfig, StereoCalib, matmul_precision_scope, resolve_device
from ..utils.chi2 import chi2_p95_table
from ..utils.lanes import add_lane_axis, at_slot, drop_lane_axis, take, where_lanes
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .augmentation import add_feature_observations, augment_state
from .propagation import ImuBatch, batched_propagate
from .pruning import compact_after_removal, find_redundant_cam_slots
from .state import FilterState, continuous_noise_cov, init_filter_state, initial_cov_diag
from .triangulation import check_motion_tracks, triangulate_tracks
from .update import (
    cam_cov_blocks,
    gating_scores,
    measurement_update,
    measurement_update_schur,
    measurement_update_schur_compact,
    schur_gating,
    schur_gating_compact,
    track_blocks,
    track_jacobians,
)

METHODS = ("qr", "cholesky", "schur")


class FrameFeatures(NamedTuple):
    """Per-frame output of the frontend (a leading B when batched)."""

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
    """One frame's published pose (a leading B when batched)."""

    time: torch.Tensor
    p: torch.Tensor  # (3,) body position in world
    q_xyzw: torch.Tensor  # (4,) Hamilton body->world quaternion
    p_cov: torch.Tensor  # (3,3) body-frame position covariance
    num_cams: torch.Tensor
    num_tracks: torch.Tensor
    tracking_rate: torch.Tensor


def check_supported(cfg: FilterConfig, method: str) -> None:
    """Raise for a filter configuration the port does not run: an unknown
    method or a negative ``ns_iters`` (ValueError).  Every precision name
    runs: the bf16 names as one or three bf16 passes per float32 product
    (``ops/precision.py``)."""
    if method not in METHODS:
        raise ValueError(f"unknown filter method {method!r}; expected one of {METHODS}")
    if cfg.ns_iters < 0:
        raise ValueError(f"ns_iters={cfg.ns_iters} must be >= 0 (0 = exact factorizations)")


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

    ``quality`` (..., Kc, Ms) per-observation template min-eig (0 =
    unknown), ``obs_mask`` the observations that belong to the track.  The
    track's noise variance inflates by clip(ref / mean quality, 1, cap); a
    track of unknown quality keeps the base noise.  Returns (..., Kc)
    weights in (0, 1]."""
    q = torch.where(obs_mask & (quality > 0), quality, torch.zeros_like(quality))
    cnt = torch.sum(q > 0, dim=-1)
    qmean = torch.sum(q, dim=-1) / torch.clamp(cnt, min=1).to(q.dtype)
    infl = torch.where(
        qmean > 0,
        torch.clamp(cfg.noise_snr_ref / torch.clamp(qmean, min=1e-12), 1.0, cfg.noise_inflation_cap),
        torch.ones_like(qmean),
    )
    return 1.0 / infl


def _gate_and_update(
    state: FilterState, params: MsckfParams, method: str, pos, obs, obs_mask, use, dof,
    max_update: int = 0, cam_idx=None, ns_iters: int = 0, w=None,
) -> FilterState:
    """Chi-square gate and compressed EKF update over the selected tracks of
    each lane (B, K).

    method='qr'/'cholesky': explicit nullspace projection, then dense
    compression (reference-faithful).  method='schur': feature-marginalized
    information accumulation, no QR; ``cam_idx`` (B, Mc) runs its whole gate
    and update camera-compacted.  ``max_update > 0`` keeps each lane's
    first ``max_update`` selected tracks (stable) before any Jacobian work.
    ``w`` (B, K), from ``_snr_weights``, scales each track's rows and
    residuals by sqrt(w), which makes the base-noise formulas the
    per-track-noise gate and update exactly."""
    if max_update and max_update < use.shape[1]:
        idx = _compact_candidates(use, max_update)
        pos, obs, obs_mask, use, dof = (take(x, idx) for x in (pos, obs, obs_mask, use, dof))
        if w is not None:
            w = take(w, idx)
    sw = None if w is None else torch.sqrt(w).to(pos.dtype)
    if method != "schur":
        jacs = track_jacobians(pos, obs, obs_mask, state.cams, state.gravity, params.R_c0_c1, params.t_c0_c1)
        if sw is not None:
            jacs = jacs._replace(H_o=jacs.H_o * sw[..., None, None], r_o=jacs.r_o * sw[..., None])
        gamma = gating_scores(jacs, state.P, params.sigma2)
        use = use & (gamma < params.chi2_table[dof])
        return measurement_update(state, jacs, use, params.sigma2, method=method)

    cams = state.cams
    if cam_idx is not None:
        cams = cams._replace(
            q=take(cams.q, cam_idx), p=take(cams.p, cam_idx),
            q_null=take(cams.q_null, cam_idx), p_null=take(cams.p_null, cam_idx),
        )
    blocks = track_blocks(pos, obs, obs_mask, cams, state.gravity, params.R_c0_c1, params.t_c0_c1)
    if sw is not None:
        blocks = _weighted(blocks, sw)
    if cam_idx is not None:
        Pc = cam_cov_blocks(state.P, cam_idx)
        gamma = schur_gating_compact(blocks, Pc, params.sigma2, ns_iters)
        use = use & (gamma < params.chi2_table[dof])
        return measurement_update_schur_compact(state, blocks, use, params.sigma2, cam_idx, ns_iters)
    gamma = schur_gating(blocks, state.P, params.sigma2, ns_iters)
    use = use & (gamma < params.chi2_table[dof])
    return measurement_update_schur(state, blocks, use, params.sigma2, ns_iters)


def _weighted(blocks, sw):
    """Blocks of each track scaled by its sqrt weight ``sw`` (B, K)."""
    return blocks._replace(
        H_x=blocks.H_x * sw[..., None, None, None],
        H_f=blocks.H_f * sw[..., None, None, None],
        r=blocks.r * sw[..., None, None],
    )


def _compact_candidates(candidates: torch.Tensor, max_update: int) -> torch.Tensor:
    """Per lane, stable indices (B, Kc) of at most ``max_update``
    candidates, selected first."""
    B, K = candidates.shape
    if not max_update or max_update >= K:
        return torch.arange(K, device=candidates.device).expand(B, K)
    return torch.argsort((~candidates).to(torch.int8), dim=1, stable=True)[:, :max_update]


def _triangulated(state: FilterState, params: MsckfParams, idx, active=None):
    """Motion check and triangulation of each lane's compacted tracks
    ``idx`` (B, Kc) (LM steps only in the lanes ``active``, all when None);
    initialized tracks keep their stored position."""
    tracks = state.tracks
    obs_c = take(tracks.obs, idx)
    obs_valid_c = take(tracks.obs_valid, idx)
    initialized_c = take(tracks.initialized, idx)
    motion_ok = check_motion_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p, params.feature_translation_threshold
    )
    tri = triangulate_tracks(
        obs_c, obs_valid_c, state.cams.q, state.cams.p, params.R_c0_c1, params.t_c0_c1, active
    )
    init_ok = torch.where(initialized_c, True, motion_ok & tri.valid)
    pos = torch.where(initialized_c[..., None], take(tracks.pos, idx), tri.pos_w)
    return obs_c, obs_valid_c, initialized_c, motion_ok & tri.valid, init_ok, pos


def _lost_candidates(state: FilterState, params: MsckfParams, max_update: int = 0):
    """Select and triangulate the tracks that lost tracking this frame."""
    tracks = state.tracks
    active = tracks.fid >= 0
    newest = torch.clamp(state.num_cams.long() - 1, min=0)
    observed_now = at_slot(tracks.obs_valid, newest, dim=2) & (state.num_cams > 0)[:, None]
    lost = active & ~observed_now
    n_obs = torch.sum(tracks.obs_valid, dim=2)
    drop_only = lost & (n_obs < 3)
    candidates = lost & (n_obs >= 3)

    idx = _compact_candidates(candidates, max_update)
    obs_c, obs_valid_c, _, _, init_ok, pos = _triangulated(state, params, idx)
    use = take(candidates, idx) & init_ok
    dof = torch.clamp(take(n_obs, idx) - 1, 1, 99)
    return idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates


def _remove_lost_features(state: FilterState, params: MsckfParams, cfg: FilterConfig, method: str) -> FilterState:
    """Triangulate and update with the tracks that lost tracking this frame
    (reference removeLostFeatures)."""
    idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates = _lost_candidates(
        state, params, cfg.max_update_tracks
    )
    w = _snr_weights(take(state.tracks.quality, idx), obs_valid_c, cfg) if cfg.noise_adaptive else None
    state = _gate_and_update(
        state, params, method, pos, obs_c, obs_valid_c & use[..., None], use, dof, ns_iters=cfg.ns_iters, w=w
    )
    gone = drop_only | candidates
    tracks = state.tracks._replace(
        fid=torch.where(gone, -1, state.tracks.fid),
        obs_valid=state.tracks.obs_valid & ~gone[..., None],
        initialized=state.tracks.initialized & ~gone,
    )
    return state._replace(tracks=tracks)


def _prune_cam_states(
    state: FilterState, params: MsckfParams, cfg: FilterConfig, method: str, lanes=None
) -> FilterState:
    """Marginalize two redundant camera states per lane (reference
    pruneCamStateBuffer).  The Schur method gates and updates
    camera-compacted to the two slots; 'qr' and 'cholesky' full-width.
    ``lanes`` (B,) names the lanes whose result is kept (the LM steps run
    only there; all lanes when None)."""
    tracks = state.tracks
    M = tracks.obs_valid.shape[2]
    dev = state.P.device
    slot_a, slot_b = find_redundant_cam_slots(
        state, params.rotation_threshold, params.translation_threshold,
        params.tracking_rate_threshold,
    )
    cam_idx = torch.stack([slot_a, slot_b], dim=1)  # (B, 2)
    involved = torch.take_along_dim(tracks.obs_valid, cam_idx[:, None, :], dim=2).to(torch.int32).sum(dim=2)
    ar = torch.arange(M, device=dev)[None, :]
    pair = (ar == slot_a[:, None]) | (ar == slot_b[:, None])  # (B, M)
    involved_mask = pair[:, None, :] & tracks.obs_valid

    update_cand = (tracks.fid >= 0) & (involved >= 2)
    idx = _compact_candidates(update_cand, cfg.max_update_tracks)
    obs_k, _, initialized_k, tri_ok, init_ok, pos = _triangulated(state, params, idx, lanes)
    cand_k = take(update_cand, idx)
    newly_init = cand_k & ~initialized_k & tri_ok
    use = cand_k & init_ok
    dof = torch.clamp(take(involved, idx), 1, 99)
    mask_k = take(involved_mask, idx)
    # The weight comes from the observations this update consumes (the two
    # pruned slots).
    w = _snr_weights(take(tracks.quality, idx), mask_k, cfg) if cfg.noise_adaptive else None
    if method == "schur":
        # Every used observation lives in the two pruned slots: (K, 8, 8)
        # gating systems and a rank-12 update instead of (K, 4M, 4M) and
        # a (D, D) one.
        mask_c = torch.take_along_dim(mask_k & use[..., None], cam_idx[:, None, :], dim=2)
        obs_c = torch.take_along_dim(obs_k, cam_idx[:, None, :, None], dim=2)
        state = _gate_and_update(
            state, params, method, pos, obs_c, mask_c, use, dof, cam_idx=cam_idx, ns_iters=cfg.ns_iters, w=w,
        )
    else:
        state = _gate_and_update(
            state, params, method, pos, obs_k, mask_k & use[..., None], use, dof, ns_iters=cfg.ns_iters, w=w,
        )

    # Persist positions of tracks initialized here; delete the involved
    # observations from every track.
    t = state.tracks
    new_pos = torch.where(newly_init[..., None], pos, take(t.pos, idx))
    tracks = t._replace(
        pos=t.pos.scatter(1, idx[..., None].expand(new_pos.shape), new_pos),
        initialized=t.initialized.scatter(1, idx, take(t.initialized, idx) | newly_init),
        obs_valid=t.obs_valid & ~involved_mask,
    )
    state = state._replace(tracks=tracks)
    return compact_after_removal(state, slot_a, slot_b)


def _online_reset(state: FilterState, params: MsckfParams) -> FilterState:
    """Uncertainty watchdog (reference onlineReset) of each lane, merged
    with ``torch.where`` so it needs no host read."""
    thr = params.position_std_threshold
    stds_ok = torch.all(torch.sqrt(torch.diagonal(state.P, dim1=-2, dim2=-1)[:, 12:15]) < thr, dim=1)
    reset = (thr > 0) & ~stds_ok  # (B,)
    t = state.tracks
    tracks = t._replace(
        fid=torch.where(reset[:, None], -1, t.fid),
        obs_valid=t.obs_valid & ~reset[:, None, None],
        initialized=t.initialized & ~reset[:, None],
    )
    return state._replace(
        num_cams=torch.where(reset, 0, state.num_cams),
        P=torch.where(reset[:, None, None], torch.diag(params.init_cov_diag), state.P),
        tracks=tracks,
        online_reset_count=state.online_reset_count + reset.to(torch.int32),
    )


def _publish(state: FilterState, time, params: MsckfParams) -> PoseOutput:
    """Body pose T_b_w = T_imu_body T_i_w T_imu_body^-1 and the body-frame
    position covariance, per lane."""
    R_bi = params.T_body_imu_R
    R_i_w = jpl_to_rot(state.imu.q).transpose(-1, -2)
    R_b_w = R_bi @ R_i_w @ R_bi.T
    return PoseOutput(
        time=time,
        p=state.imu.p @ R_bi.T,
        q_xyzw=rot_to_jpl(R_b_w.transpose(-1, -2)),
        p_cov=R_bi @ state.P[:, 12:15, 12:15] @ R_bi.T,
        num_cams=state.num_cams,
        num_tracks=torch.sum(state.tracks.fid >= 0, dim=1),
        tracking_rate=state.tracking_rate,
    )


def _propagate_augment_observe(state: FilterState, frame: FrameFeatures, imu: ImuBatch, params: MsckfParams):
    """Shared front half of ``batched_filter_step`` and ``filter_internals``:
    the time origin on each lane's first frame, IMU propagation, state
    augmentation and observation bookkeeping."""
    first = state.next_sid == 0
    state = state._replace(imu=state.imu._replace(time=torch.where(first, frame.time, state.imu.time)))
    state = batched_propagate(state, imu, params.Q_imu)
    state = augment_state(state, frame.time)
    quality = frame.quality
    if quality is None:
        quality = torch.zeros_like(frame.uv[..., 0])
    return add_feature_observations(state, frame.fid, frame.uv, frame.valid, quality)


def filter_step(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "qr",
):
    """One frame of one sequence's back-end: the one-lane view of
    ``batched_filter_step``.  Returns (state, PoseOutput)."""
    state, out = batched_filter_step(
        add_lane_axis(state), add_lane_axis(frame), add_lane_axis(imu), params, cfg, method
    )
    return drop_lane_axis(state), drop_lane_axis(out)


def batched_filter_step(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "qr",
):
    """One frame of the back-end of B sequences: ``state``, ``frame`` and
    ``imu`` with a leading lane axis.  The camera prune is JAX's ``lax.cond``
    under ``vmap``: one host read asks whether any lane's window is full;
    if so the prune runs on the whole batch and its result is kept in those
    lanes only.  Returns (state, PoseOutput)."""
    check_supported(cfg, method)
    with matmul_precision_scope(cfg.matmul_precision):
        state = _propagate_augment_observe(state, frame, imu, params)
        state = _remove_lost_features(state, params, cfg, method)
        full = state.num_cams >= cfg.max_cam_state_size
        if bool(torch.any(full)):  # one host read per frame, for every lane
            state = where_lanes(full, _prune_cam_states(state, params, cfg, method, full), state)
        out = _publish(state, frame.time, params)
        state = _online_reset(state, params)
        return state, out


def filter_internals(
    state: FilterState,
    frame: FrameFeatures,
    imu: ImuBatch,
    params: MsckfParams,
    cfg: FilterConfig,
    method: str = "qr",
) -> dict:
    """Differential-debug dump of one sequence's frame (the analog of the
    reference's frame-9 Jacobian dump): from the filter state *before* the
    frame, replays propagation, augmentation and observation bookkeeping
    and returns, without advancing any state, every tensor the lost-track
    update would consume: candidate tracks, triangulated positions, the
    OC-projected Jacobian blocks, the nullspace-projected rows, and the
    gating scores of both algebras against their chi-square thresholds.
    The keys are the JAX package's."""
    check_supported(cfg, method)
    with matmul_precision_scope(cfg.matmul_precision):
        state = _propagate_augment_observe(
            add_lane_axis(state), add_lane_axis(frame), add_lane_axis(imu), params
        )
        idx, obs_c, obs_valid_c, use, dof, pos, drop_only, candidates = _lost_candidates(
            state, params, cfg.max_update_tracks
        )
        obs_mask = obs_valid_c & use[..., None]
        args = (pos, obs_c, obs_mask, state.cams, state.gravity, params.R_c0_c1, params.t_c0_c1)
        blocks, jacs = track_blocks(*args), track_jacobians(*args)
        if cfg.noise_adaptive:
            # Mirror the live filter's SNR weighting in the dumped tensors.
            sw = torch.sqrt(_snr_weights(take(state.tracks.quality, idx), obs_valid_c, cfg)).to(pos.dtype)
            blocks = _weighted(blocks, sw)
            jacs = jacs._replace(H_o=jacs.H_o * sw[..., None, None], r_o=jacs.r_o * sw[..., None])
        gamma_qr = gating_scores(jacs, state.P, params.sigma2)
        gamma_schur = schur_gating(blocks, state.P, params.sigma2, cfg.ns_iters)
        thresh = params.chi2_table[dof]
        out = {
            "num_cams": state.num_cams,
            "cam_q": state.cams.q,
            "cam_p": state.cams.p,
            "cov_diag": torch.diagonal(state.P, dim1=-2, dim2=-1),
            "candidate_idx": idx.to(torch.int32),
            "candidate_fid": take(state.tracks.fid, idx),
            "candidate_use": use,
            "candidate_dof": dof,
            "n_lost_short": torch.sum(drop_only, dim=1),
            "n_candidates": torch.sum(candidates, dim=1),
            "pos_w": pos,
            "obs": obs_c,
            "obs_mask": obs_mask,
            "H_x_blocks": blocks.H_x,
            "H_f_blocks": blocks.H_f,
            "r_blocks": blocks.r,
            "H_o": jacs.H_o,
            "r_o": jacs.r_o,
            "rows_valid": jacs.rows_valid,
            "gamma_qr": gamma_qr,
            "gamma_schur": gamma_schur,
            "chi2_threshold": thresh,
            "gate_pass_qr": use & (gamma_qr < thresh),
            "gate_pass_schur": use & (gamma_schur < thresh),
        }
        return {k: v[0] for k, v in out.items()}


def init_state(cfg: FilterConfig, calib: StereoCalib, dtype=torch.float64, device=None) -> FilterState:
    """One sequence's initial filter state on ``device`` (the CUDA card when
    None; raises without CUDA unless a device is named)."""
    return init_filter_state(cfg, calib, dtype, resolve_device(device))


def reset_filter(state: FilterState, cfg: FilterConfig, calib: StereoCalib) -> FilterState:
    """Full manual reset (reference resetCallback): the state and covariance
    rebuilt from the configuration on the state's device and dtype, with
    cameras, tracks and timing cleared; only gravity is kept.  The sequence
    runners never call it."""
    fresh = init_filter_state(cfg, calib, state.P.dtype, state.P.device)
    return fresh._replace(gravity=state.gravity)
