"""Stereo feature-tracking front-end as one fixed-shape step per frame
(port of ``msckf_stereo_c_tpu/models/frontend.py``, main configuration).

A pool of ``max_features`` track slots replaces the reference's grid map;
per-grid ranking and pruning are sort/cumsum computations over the pool.
Per frame: temporal LK on carried templates -> FAST candidates -> candidate
coarse walk -> fused stereo + anchor + left-right fine level -> gates ->
allocate, prune, publish.

The configuration ``bench.py`` runs is ported (corr KLT, template carry,
fused stereo, RANSAC off) with every photometric norm (``klt_norm``);
``check_supported`` raises ``NotImplementedError`` naming any other option.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import FrontendConfig, StereoCalib, matmul_precision_scope
from ..ops.camera import distort_points, undistort_points
from ..ops.fast import detect_grid_corners, occupancy_from_points
from ..ops.klt_corr import (
    fused_stereo_supported,
    optical_flow_lk_corr_l0,
    optical_flow_pyr_lk_corr,
    stereo_anchor_lr_fused,
)
from ..ops.pyramid import build_pyramid, smooth5
from ..utils.lie import so3_exp


class TrackerState(NamedTuple):
    """Fixed pool of feature tracks (see the JAX original for each field)."""

    pts0: torch.Tensor  # (N, 2) cam0 pixel positions
    pts1: torch.Tensor  # (N, 2) cam1 pixel positions
    fid: torch.Tensor  # (N,) int32, -1 = free
    lifetime: torch.Tensor  # (N,) int32
    response: torch.Tensor  # (N,)
    next_fid: torch.Tensor  # () int32
    tmpl: torch.Tensor  # (N, P+2, P+2) carried templates at pts0
    depth: torch.Tensor  # (N,) last stereo depth (0 = unknown)
    anchor: torch.Tensor  # (N, P+2, P+2) birth templates
    snr: torch.Tensor  # (N,) template min-eig of the last stereo match


class FrontendParams(NamedTuple):
    """Calibration for the front-end, as tensors on the run's device."""

    K0: torch.Tensor  # (4,) fx fy cx cy cam0
    D0: torch.Tensor  # (4,)
    K1: torch.Tensor  # (4,)
    D1: torch.Tensor  # (4,)
    R_c0_c1: torch.Tensor  # (3,3) rotation of T_cn_cnm1
    t_c0_c1: torch.Tensor  # (3,)
    R_imu_cam0: torch.Tensor  # (3,3)
    R_imu_cam1: torch.Tensor  # (3,3)
    E: torch.Tensor  # (3,3) essential matrix [t]x R
    norm_pixel_unit: torch.Tensor  # () 4/(fx0+fy0+fx1+fy1)


class FrameOutput(NamedTuple):
    fid: torch.Tensor  # (N,) int32
    uv: torch.Tensor  # (N, 4) normalized stereo observations
    valid: torch.Tensor  # (N,)
    before_tracking: torch.Tensor
    after_tracking: torch.Tensor
    after_matching: torch.Tensor
    after_ransac: torch.Tensor
    anchor_accepted: torch.Tensor
    quality: torch.Tensor  # (N,)


def _norms(cfg: FrontendConfig) -> Tuple[str, str]:
    """(frame-to-frame, anchor) photometric norms for cfg.klt_norm: 'mixed'
    runs the damped offset solve on the frame-to-frame problems and the
    affine-photometric solve on the anchor, whose birth template spans the
    whole exposure drift; 'anchor_gain' keeps the raw path everywhere but
    the anchor (see the JAX original and docs/STRESS_NOTES.md round 5)."""
    if cfg.klt_norm == "mixed":
        return "offset", "gain"
    if cfg.klt_norm == "anchor_gain":
        return "none", "gain"
    return cfg.klt_norm, cfg.klt_norm


def check_supported(cfg: FrontendConfig, img_shape) -> None:
    """Raise NotImplementedError for a configuration the port does not
    cover yet; nothing is approximated silently."""
    unsupported = [
        ("klt_impl", cfg.klt_impl != "corr"),
        ("ransac_enabled", cfg.ransac_enabled),
        ("temporal_levels", cfg.temporal_levels != 1),
        ("stereo_levels", cfg.stereo_levels != 1),
        ("tmpl_carry", not cfg.tmpl_carry),
        ("stereo_lr_threshold", not cfg.stereo_lr_threshold > 0),
        ("stereo_lr_survivors", not cfg.stereo_lr_survivors),
        ("anchor_refine", not cfg.anchor_refine),
        ("translation_seed", not cfg.translation_seed),
        ("pyramid_levels", cfg.pyramid_levels <= 2),
        ("image size", not fused_stereo_supported(img_shape, cfg.patch_size)),
    ]
    for name, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"the PyTorch port covers the bench configuration and the klt_norm "
                f"modes only; {name}={getattr(cfg, name, img_shape)!r} is not ported yet"
            )


def make_frontend_params(
    calib: StereoCalib, dtype=torch.float32, device=None
) -> FrontendParams:
    T01 = calib.T_cam0_cam1_mat()
    R01 = T01[:3, :3]
    t01 = T01[:3, 3]
    tx = np.array([[0.0, -t01[2], t01[1]], [t01[2], 0.0, -t01[0]], [-t01[1], t01[0], 0.0]])
    E = tx @ R01
    fx0, fy0 = calib.cam0.intrinsics[:2]
    fx1, fy1 = calib.cam1.intrinsics[:2]
    R_i_c1 = (T01 @ calib.cam0.T_cam_imu_mat())[:3, :3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return FrontendParams(
        K0=t(calib.cam0.intrinsics),
        D0=t(calib.cam0.distortion_coeffs),
        K1=t(calib.cam1.intrinsics),
        D1=t(calib.cam1.distortion_coeffs),
        R_c0_c1=t(R01),
        t_c0_c1=t(t01),
        R_imu_cam0=t(calib.cam0.T_cam_imu_mat()[:3, :3]),
        R_imu_cam1=t(R_i_c1),
        E=t(E),
        norm_pixel_unit=t(4.0 / (fx0 + fy0 + fx1 + fy1)),
    )


def init_tracker_state(cfg: FrontendConfig, dtype=torch.float32, device=None) -> TrackerState:
    N = cfg.max_features
    q = cfg.patch_size + 2

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return TrackerState(
        pts0=z(N, 2),
        pts1=z(N, 2),
        fid=-torch.ones((N,), dtype=torch.int32, device=device),
        lifetime=z(N, dt=torch.int32),
        response=z(N),
        next_fid=z(dt=torch.int32),
        tmpl=z(N, q, q),
        depth=z(N),
        anchor=z(N, q, q),
        snr=z(N),
    )


def _scatter_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for indices in [0, len(x)]:
    index len(x) lands in a dump row that is sliced off."""
    pad = torch.cat([x, x[:1]], dim=0)
    shape = (idx.shape[0],) + x.shape[1:]
    val = val.to(x.dtype).expand(shape) if torch.is_tensor(val) else x.new_full(shape, val)
    return pad.index_put((idx.long(),), val)[:-1]


def _count_into(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``zeros(n).at[idx].add(1, mode="drop")`` for indices in [0, n]."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.long(), torch.ones_like(idx, dtype=torch.int32))
    return out[:n]


def _grid_code(pts, img_shape, cfg: FrontendConfig):
    H, W = img_shape
    gh = H // cfg.grid_row
    gw = W // cfg.grid_col
    row = torch.clamp((pts[:, 1] // gh).to(torch.int64), 0, cfg.grid_row - 1)
    col = torch.clamp((pts[:, 0] // gw).to(torch.int64), 0, cfg.grid_col - 1)
    return row * cfg.grid_col + col


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))``: sort by major, then minor, stable."""
    i1 = torch.argsort(minor, stable=True)
    i2 = torch.argsort(major[i1], stable=True)
    return i1[i2]


def _rank_within_group(group, order_key, valid, num_groups: int):
    """Rank of each element within its group by ascending ``order_key``;
    invalid elements get rank n."""
    n = group.shape[0]
    g = torch.where(valid, group, torch.full_like(group, num_groups))
    sorted_idx = _lexsort(order_key, g)
    sorted_g = g[sorted_idx]
    pos = torch.arange(n, device=group.device)
    first_pos = torch.searchsorted(
        sorted_g, torch.arange(num_groups + 1, device=group.device, dtype=sorted_g.dtype)
    )
    rank_sorted = pos - first_pos[sorted_g]
    rank = torch.zeros(n, dtype=torch.int64, device=group.device)
    rank = rank.index_put((sorted_idx,), rank_sorted)
    return torch.where(valid, rank, torch.full_like(rank, n))


def _detect_candidates(pts0, pts_valid, img_top, cfg: FrontendConfig, img_shape):
    """FAST corners away from current tracks, sieved to the per-grid top
    ``grid_max_feature_num`` and cut to ``cand_budget`` by need."""
    occupied = occupancy_from_points(pts0, pts_valid, img_shape, cfg.detector_cell)
    corners = detect_grid_corners(img_top, float(cfg.fast_threshold), cfg.detector_cell, occupied)
    G, gmax = cfg.num_grids, cfg.grid_max_feature_num
    cand_grid = _grid_code(corners.xy, img_shape, cfg)
    rank = _rank_within_group(cand_grid, -corners.score, corners.valid, G)
    C = G * gmax
    slot = torch.where(rank < gmax, cand_grid * gmax + rank, C)
    dev = pts0.device
    cand_xy = _scatter_drop(torch.zeros((C, 2), dtype=corners.xy.dtype, device=dev), slot, corners.xy)
    cand_score = _scatter_drop(
        torch.zeros((C,), dtype=corners.score.dtype, device=dev), slot, corners.score
    )
    cand_valid = _scatter_drop(torch.zeros((C,), dtype=torch.bool, device=dev), slot, corners.valid)

    B = cfg.cand_budget
    if B and B < C:
        est_count = _count_into(torch.where(pts_valid, _grid_code(pts0, img_shape, cfg), G), G)
        ar = torch.arange(C, device=dev)
        g_of_slot = ar // gmax
        r_of_slot = ar % gmax
        need = torch.clamp(cfg.grid_min_feature_num - est_count, min=0)
        need_rank = torch.where(cand_valid, r_of_slot - need[g_of_slot], C)
        idx = _lexsort(-cand_score, need_rank)[:B]
        return cand_xy[idx], cand_score[idx], cand_valid[idx]
    return cand_xy, cand_score, cand_valid


def _stereo_match_merged(
    pyr0: Sequence[torch.Tensor],
    pyr1: Sequence[torch.Tensor],
    pts_surv, surv_guess, surv_valid, cand_xy, cand_valid,
    params: FrontendParams, cfg: FrontendConfig, img_shape, anchor_sp=None,
):
    """Stereo match of surviving tracks (carried disparity, full resolution)
    and candidates (extrinsic guess, coarse walk at levels 3, 2, 1 first) in
    one fused fine-level call, then the epipolar, cheirality and
    left-right gates over the union.  Returns the same tuple as the JAX
    original's fused branch."""
    H, W = img_shape
    norm, anchor_norm = _norms(cfg)
    kw = dict(win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision)

    xn = undistort_points(cand_xy, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1)
    cguess = distort_points(xn, params.K1, params.D1, model=cfg.distortion_model1)
    s = 4.0  # scale of pyramid level 2
    res_c = optical_flow_pyr_lk_corr(
        pyr0[2:], pyr1[2:], cand_xy / s, cguess / s, cand_valid, norm=norm, **kw
    )
    cguess = res_c.pts * s
    if cfg.cand_level1:
        res_m = optical_flow_pyr_lk_corr(
            pyr0[1:2], pyr1[1:2], cand_xy / 2.0, cguess / 2.0, cand_valid, norm=norm, **kw
        )
        cguess = res_m.pts * 2.0

    n_surv = pts_surv.shape[0]
    pts0 = torch.cat([pts_surv, cand_xy], dim=0)
    guess = torch.cat([surv_guess, cguess], dim=0)
    valid = torch.cat([surv_valid, cand_valid], dim=0)
    pts0, acc, res, rt2, sp_all, me_all = stereo_anchor_lr_fused(
        pyr0[0], pyr1[0], pts0, guess, valid, **kw,
        anchor_sp=anchor_sp,
        anchor_valid=surv_valid if anchor_sp is not None else None,
        anchor_radius=cfg.anchor_radius,
        norm=norm,
        anchor_norm=anchor_norm,
    )
    n_anchor = (
        torch.zeros((), dtype=torch.int32, device=pts0.device)
        if acc is None else torch.sum(acc).to(torch.int32)
    )
    pts1 = res.pts
    ok = res.valid & valid
    ok = ok & (pts1[:, 0] >= 0) & (pts1[:, 0] <= W - 1) & (pts1[:, 1] >= 0) & (pts1[:, 1] <= H - 1)

    # Epipolar consistency with the essential matrix.
    un0 = undistort_points(pts0, params.K0, params.D0, model=cfg.distortion_model0)
    un1 = undistort_points(pts1, params.K1, params.D1, model=cfg.distortion_model1)
    p0h = torch.cat([un0, torch.ones_like(un0[:, :1])], dim=1)
    p1h = torch.cat([un1, torch.ones_like(un1[:, :1])], dim=1)
    line = p0h @ params.E.T
    dist = torch.abs(torch.sum(p1h * line, dim=1)) / torch.sqrt(
        line[:, 0] ** 2 + line[:, 1] ** 2 + 1e-12
    )
    ok = ok & (dist <= cfg.stereo_threshold * params.norm_pixel_unit)

    # Cheirality along the baseline, and the per-lane depth estimate.
    xn_inf = undistort_points(pts0, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1)
    bdir = -params.t_c0_c1[:2]
    bnorm = torch.sqrt(torch.sum(bdir * bdir)) + 1e-12
    disp_along = ((xn_inf - un1) @ bdir) / bnorm
    ok = ok & (disp_along >= -0.5 * params.norm_pixel_unit)
    depth = torch.where(
        ok, bnorm / torch.maximum(disp_along, bnorm / 1000.0), torch.zeros_like(disp_along)
    ).to(pts1.dtype)

    # Left-right round trip (ran inside the fused call).
    ok = ok & (rt2 <= cfg.stereo_lr_threshold**2)

    return (
        (pts0[:n_surv], pts1[:n_surv], ok[:n_surv], depth[:n_surv]),
        (pts1[n_surv:], ok[n_surv:], depth[n_surv:]),
        (sp_all[:n_surv], sp_all[n_surv:]),
        n_anchor,
        (me_all[:n_surv], me_all[n_surv:]),
    )


def _allocate_new_features(
    state: TrackerState, cand_xy, cand_score, cand_pts1, cand_ok,
    cfg: FrontendConfig, img_shape, fill_to: int,
    cand_tmpl, cand_depth, cand_snr,
) -> TrackerState:
    """Fill grids below ``fill_to`` with stereo-matched candidates."""
    N = cfg.max_features
    G = cfg.num_grids
    dev = cand_xy.device
    pool_grid = _grid_code(state.pts0, img_shape, cfg)
    pool_count = _count_into(
        torch.where(state.fid >= 0, pool_grid, torch.full_like(pool_grid, G)), G
    )
    vacancy = torch.clamp(fill_to - pool_count, min=0)

    cgrid = _grid_code(cand_xy, img_shape, cfg)
    crank = _rank_within_group(cgrid, -cand_score, cand_ok, G)
    accept = cand_ok & (crank < vacancy[cgrid])

    free = state.fid < 0
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    slot_of_rank = _scatter_drop(
        torch.full((N,), N, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, torch.full_like(free_rank, N)),
        torch.arange(N, device=dev),
    )
    n_free = torch.sum(free)
    acc_rank = torch.cumsum(accept.to(torch.int64), 0) - 1
    placed = accept & (acc_rank < n_free)
    target = torch.where(
        placed, slot_of_rank[torch.clamp(acc_rank, 0, N - 1)], torch.full_like(acc_rank, N)
    )

    new_fid = state.next_fid + acc_rank.to(torch.int32)
    n_added = torch.sum(placed).to(torch.int32)
    return state._replace(
        pts0=_scatter_drop(state.pts0, target, cand_xy),
        pts1=_scatter_drop(state.pts1, target, cand_pts1),
        fid=_scatter_drop(state.fid, target, new_fid),
        lifetime=_scatter_drop(state.lifetime, target, 1),
        response=_scatter_drop(state.response, target, cand_score.to(state.response.dtype)),
        next_fid=state.next_fid + n_added,
        tmpl=_scatter_drop(state.tmpl, target, cand_tmpl.to(state.tmpl.dtype)),
        depth=_scatter_drop(state.depth, target, cand_depth.to(state.depth.dtype)),
        # The candidate's stereo template is its birth appearance: the anchor.
        anchor=_scatter_drop(state.anchor, target, cand_tmpl.to(state.anchor.dtype)),
        snr=_scatter_drop(state.snr, target, cand_snr.to(state.snr.dtype)),
    )


def _prune_grid_features(state: TrackerState, cfg: FrontendConfig, img_shape) -> TrackerState:
    """Cap each grid at grid_max_feature_num, keeping the longest-lived."""
    grid = _grid_code(state.pts0, img_shape, cfg)
    rank = _rank_within_group(grid, -state.lifetime, state.fid >= 0, cfg.num_grids)
    keep = rank < cfg.grid_max_feature_num
    return state._replace(fid=torch.where(keep, state.fid, torch.full_like(state.fid, -1)))


def _publish(state: TrackerState, params: FrontendParams, cfg: FrontendConfig, dtype):
    """Undistort to normalized coordinates and emit the measurement set."""
    un0 = undistort_points(state.pts0, params.K0, params.D0, model=cfg.distortion_model0)
    un1 = undistort_points(state.pts1, params.K1, params.D1, model=cfg.distortion_model1)
    uv = torch.cat([un0, un1], dim=1).to(dtype)
    return state.fid, uv, state.fid >= 0


def frontend_step(
    state: TrackerState,
    pyr0_prev: Sequence[torch.Tensor],
    pyr0_curr: Sequence[torch.Tensor],
    pyr1_curr: Sequence[torch.Tensor],
    mean_gyro: torch.Tensor,
    dt: torch.Tensor,
    is_first: torch.Tensor,
    params: FrontendParams,
    cfg: FrontendConfig,
    cam_vel: torch.Tensor,
):
    """One stereo frame through the tracker.  Returns (state, FrameOutput).
    ``cam_vel`` is the cam0-frame velocity for the translation-aware
    temporal prediction."""
    check_supported(cfg, tuple(pyr0_curr[0].shape))
    with matmul_precision_scope(cfg.matmul_precision):
        return _frontend_step_impl(
            state, pyr0_prev, pyr0_curr, pyr1_curr, mean_gyro, dt, is_first,
            params, cfg, cam_vel,
        )


def _frontend_step_impl(
    state, pyr0_prev, pyr0_curr, pyr1_curr, mean_gyro, dt, is_first, params, cfg, cam_vel
):
    img_shape = tuple(pyr0_curr[0].shape)
    H, W = img_shape
    before_tracking = torch.sum(state.fid >= 0)

    # --- Temporal tracking with the translation-aware prediction.
    w_cam = params.R_imu_cam0 @ mean_gyro
    R_p_c = so3_exp(w_cam * dt).T
    xn = undistort_points(state.pts0, params.K0, params.D0, model=cfg.distortion_model0)
    z0 = torch.where(state.depth > 0.3, state.depth, torch.full_like(state.depth, 1e6))
    X = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=1) * z0[:, None]
    Xp = (X - cam_vel * dt) @ R_p_c.T
    zc = torch.clamp(Xp[:, 2], min=0.3)
    guess = distort_points(Xp[:, :2] / zc[:, None], params.K0, params.D0, model=cfg.distortion_model0)
    depth_ratio = torch.clamp(z0 / zc, 0.5, 2.0)

    active = state.fid >= 0
    res, _ = optical_flow_lk_corr_l0(
        pyr0_prev[0], pyr0_curr[0], state.pts0, guess, active,
        win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision,
        tmpl_sp=state.tmpl, norm=_norms(cfg)[0],
    )
    tracked_pts0 = res.pts
    tracked = active & res.valid
    tracked = tracked & (tracked_pts0[:, 0] >= 0) & (tracked_pts0[:, 0] <= W - 1)
    tracked = tracked & (tracked_pts0[:, 1] >= 0) & (tracked_pts0[:, 1] <= H - 1)
    after_tracking = torch.sum(tracked)

    # --- New-feature candidates away from the tracked features.
    cand_xy, cand_score, cand_valid = _detect_candidates(
        tracked_pts0, tracked, pyr0_curr[0], cfg, img_shape
    )

    # --- Stereo match with the anchor refinement fused in.
    disparity_guess = tracked_pts0 + (state.pts1 - state.pts0) * depth_ratio[:, None]
    (
        (tracked_pts0, pts1, matched, surv_depth),
        (cand_pts1, cand_ok, cand_depth),
        (surv_tmpl, cand_tmpl),
        n_anchor,
        (surv_snr, cand_snr),
    ) = _stereo_match_merged(
        pyr0_curr, pyr1_curr, tracked_pts0, disparity_guess, tracked,
        cand_xy, cand_valid, params, cfg, img_shape, anchor_sp=state.anchor,
    )
    after_matching = torch.sum(matched)

    surv = matched & ~is_first
    state = state._replace(
        pts0=torch.where(surv[:, None], tracked_pts0, state.pts0),
        pts1=torch.where(surv[:, None], pts1, state.pts1),
        fid=torch.where(surv, state.fid, torch.full_like(state.fid, -1)),
        lifetime=torch.where(surv, state.lifetime + 1, torch.zeros_like(state.lifetime)),
        depth=torch.where(surv, surv_depth, torch.zeros_like(surv_depth)),
        tmpl=torch.where(surv[:, None, None], surv_tmpl.to(state.tmpl.dtype), state.tmpl),
        snr=torch.where(surv, surv_snr.to(state.snr.dtype), torch.zeros_like(state.snr)),
    )

    # --- Fill under-populated grids with matched candidates; prune.
    state = _allocate_new_features(
        state, cand_xy, cand_score, cand_pts1, cand_ok, cfg, img_shape,
        cfg.grid_min_feature_num, cand_tmpl, cand_depth, cand_snr,
    )
    state = _prune_grid_features(state, cfg, img_shape)

    fid, uv, valid = _publish(state, params, cfg, state.pts0.dtype)
    out = FrameOutput(
        fid=fid, uv=uv, valid=valid,
        before_tracking=before_tracking,
        after_tracking=after_tracking,
        after_matching=after_matching,
        after_ransac=torch.sum(valid),
        anchor_accepted=n_anchor,
        quality=state.snr,
    )
    return state, out


def pyramids_for(img: torch.Tensor, cfg: FrontendConfig) -> Tuple[torch.Tensor, ...]:
    """Image pyramid for the tracker; with cfg.presmooth the full-resolution
    level is the 5-tap prefiltered image, coarse levels the raw pyrDown
    chain."""
    pyr = build_pyramid(img, cfg.pyramid_levels)
    if cfg.presmooth:
        pyr = [smooth5(img)] + pyr[1:]
    return tuple(pyr)
