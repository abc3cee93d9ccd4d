"""Stereo feature-tracking front-end as one fixed-shape step per frame
(port of ``msckf_stereo_c_tpu/models/frontend.py``).

A pool of ``max_features`` track slots replaces the reference's grid map;
per-grid ranking and pruning are sort/cumsum computations over the pool.
Per frame: temporal LK (carried templates, or ``temporal_levels`` pyramid
levels) from the translation-aware or the rotation-only prediction ->
standalone anchor refinement where the fused call is off -> FAST
candidates -> candidate coarse walk -> stereo fine level (fused stereo +
anchor + left-right, or the unfused call and backward pass) -> gates ->
optional two-point RANSAC on both cameras -> allocate, prune, publish.

Every ``FrontendConfig`` the JAX package accepts runs here; an unknown
``klt_impl`` raises ``ValueError`` as there.  ``klt_impl='corr'`` runs the
hand kernels (``ops/klt_corr.py``); ``'gather'`` and ``'gemm'`` run the
bilinear-gather LK (``ops/klt.py``), plain PyTorch as in JAX.

``batched_frontend_step`` steps B sequences at once: every tensor of the
state carries a leading lane axis, and each LK or template kernel launches
once for the features of all lanes.  ``frontend_step`` is its one-lane
view.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FrontendConfig, StereoCalib, matmul_precision_scope
from ..ops.camera import distort_points, undistort_points
from ..ops import precision
from ..ops import ransac as _ransac
from ..ops.fast import detect_grid_corners, occupancy_from_points
from ..ops.klt import optical_flow_pyr_lk
from ..ops.klt_corr import (
    fused_stereo_supported,
    optical_flow_lk_corr_l0,
    optical_flow_pyr_lk_corr,
    stereo_anchor_lr_fused,
)
from ..ops.pyramid import tracker_pyramid
from ..utils.lanes import add_lane_axis, count_into, drop_lane_axis, lane_index, scatter_drop, take
from ..utils.lie import so3_exp
from ..utils.timing import span

# 'gemm' is served by the gather LK: the JAX package's matmul resampling
# computes the same LK (tests/test_klt_gemm.py) and exists for the TPU's
# gather cost.
_KLT_IMPLS = {
    "gemm": optical_flow_pyr_lk,
    "corr": optical_flow_pyr_lk_corr,
    "gather": optical_flow_pyr_lk,
}


class TrackerState(NamedTuple):
    """Fixed pool of feature tracks (see the JAX original for each field);
    the shapes are one lane's, a batched state adds a leading B."""

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
    """One frame's measurement set and counters (a leading B when
    batched)."""

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


def _klt_fn(name: str, norm: str = "none"):
    """The pyramidal LK of ``klt_impl`` ``name``; 'corr' takes the
    photometric ``norm``, the gather LK has none (as in JAX)."""
    try:
        fn = _KLT_IMPLS[name]
    except KeyError:
        raise ValueError(f"unknown klt_impl {name!r}; choose from {sorted(_KLT_IMPLS)}") from None
    if name == "corr" and norm != "none":
        return functools.partial(fn, norm=norm)
    return fn


def _tmpl_carry_active(cfg: FrontendConfig) -> bool:
    """Template carry needs single-level temporal and stereo fine calls of
    the corr implementation: the carried patch must be what the next call
    would extract."""
    return cfg.tmpl_carry and cfg.klt_impl == "corr" and cfg.temporal_levels == 1 and cfg.stereo_levels == 1


def _fused_stereo_active(cfg: FrontendConfig, img_shape) -> bool:
    """The fused stereo + left-right + anchor fine level replaces the
    unfused composition for the corr implementation with one fine level,
    the full-union left-right check and an image that holds its margined
    search windows."""
    return (
        cfg.klt_impl == "corr"
        and cfg.stereo_levels == 1
        and cfg.stereo_lr_threshold > 0
        and cfg.stereo_lr_survivors
        and fused_stereo_supported(img_shape, cfg.patch_size)
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


def _grid_code(pts, img_shape, cfg: FrontendConfig):
    H, W = img_shape
    gh = H // cfg.grid_row
    gw = W // cfg.grid_col
    row = torch.clamp((pts[..., 1] // gh).to(torch.int64), 0, cfg.grid_row - 1)
    col = torch.clamp((pts[..., 0] // gw).to(torch.int64), 0, cfg.grid_col - 1)
    return row * cfg.grid_col + col


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))`` along the last axis: sort by major,
    then minor, stable."""
    i1 = torch.argsort(minor, dim=-1, stable=True)
    i2 = torch.argsort(torch.take_along_dim(major, i1, dim=-1), dim=-1, stable=True)
    return torch.take_along_dim(i1, i2, dim=-1)


def _rank_within_group(group, order_key, valid, num_groups: int):
    """Rank of each element within its group by ascending ``order_key``,
    per lane of (B, n) inputs; invalid elements get rank n."""
    n = group.shape[-1]
    g = torch.where(valid, group, torch.full_like(group, num_groups))
    sorted_idx = _lexsort(order_key, g)
    sorted_g = torch.take_along_dim(g, sorted_idx, dim=-1)
    bounds = torch.arange(num_groups + 1, device=group.device, dtype=sorted_g.dtype)
    first_pos = torch.searchsorted(sorted_g, bounds.expand(g.shape[:-1] + bounds.shape).contiguous())
    rank_sorted = torch.arange(n, device=group.device) - torch.take_along_dim(first_pos, sorted_g, dim=-1)
    rank = torch.zeros_like(sorted_idx).scatter(-1, sorted_idx, rank_sorted)
    return torch.where(valid, rank, torch.full_like(rank, n))


def _detect_candidates(pts0, pts_valid, img_top, cfg: FrontendConfig, img_shape):
    """FAST corners away from current tracks, sieved to the per-grid top
    ``grid_max_feature_num`` and cut to ``cand_budget`` by need, per lane:
    ``pts0`` (B, N, 2), ``img_top`` (B, H, W)."""
    occupied = occupancy_from_points(pts0, pts_valid, img_shape, cfg.detector_cell)
    corners = detect_grid_corners(img_top, float(cfg.fast_threshold), cfg.detector_cell, occupied)
    G, gmax = cfg.num_grids, cfg.grid_max_feature_num
    cand_grid = _grid_code(corners.xy, img_shape, cfg)
    rank = _rank_within_group(cand_grid, -corners.score, corners.valid, G)
    C = G * gmax
    slot = torch.where(rank < gmax, cand_grid * gmax + rank, C)
    B, dev = pts0.shape[0], pts0.device
    cand_xy = scatter_drop(torch.zeros((B, C, 2), dtype=corners.xy.dtype, device=dev), slot, corners.xy)
    cand_score = scatter_drop(torch.zeros((B, C), dtype=corners.score.dtype, device=dev), slot, corners.score)
    cand_valid = scatter_drop(torch.zeros((B, C), dtype=torch.bool, device=dev), slot, corners.valid)

    budget = cfg.cand_budget
    if budget and budget < C:
        est_count = count_into(torch.where(pts_valid, _grid_code(pts0, img_shape, cfg), G), G)
        ar = torch.arange(C, device=dev)
        g_of_slot = ar // gmax
        r_of_slot = ar % gmax
        need = torch.clamp(cfg.grid_min_feature_num - est_count, min=0)
        need_rank = torch.where(cand_valid, r_of_slot - need[:, g_of_slot], C)
        idx = _lexsort(-cand_score, need_rank)[:, :budget]
        return take(cand_xy, idx), take(cand_score, idx), take(cand_valid, idx)
    return cand_xy, cand_score, cand_valid


def _stereo_match_merged(
    pyr0: Sequence[torch.Tensor],
    pyr1: Sequence[torch.Tensor],
    pts_surv, surv_guess, surv_valid, cand_xy, cand_valid,
    params: FrontendParams, cfg: FrontendConfig, img_shape, anchor_sp=None,
):
    """Stereo match of surviving tracks (carried disparity) and candidates
    (extrinsic guess, coarse walk from level 3 down to the shared fine
    levels first) over their union, then the epipolar, cheirality and
    left-right gates.  The fine level is the fused stereo + anchor +
    left-right call where ``_fused_stereo_active``, else one corr call that
    returns the templates (template carry) or the ``stereo_levels``-level
    LK of ``klt_impl``, with the backward left-right pass over the union,
    or over the candidates only without ``stereo_lr_survivors``.  Per lane:
    ``pts_surv`` (B, N, 2), ``cand_xy`` (B, C, 2), pyramid levels
    (B, h, w); every LK call takes the B x N survivors and B x C candidates
    flattened into one feature axis (survivors of every lane first).
    Returns the JAX original's tuple with a leading lane axis; the
    templates and the template min-eigenvalues are None where no call
    made them."""
    H, W = img_shape
    B, N = pts_surv.shape[:2]
    C = cand_xy.shape[1]
    dev = pts_surv.device
    L = len(pyr0)
    norm, anchor_norm = _norms(cfg)
    klt = _klt_fn(cfg.klt_impl, norm)
    kw = dict(win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision)
    idx_c = lane_index(B, C, dev)

    xn = undistort_points(cand_xy, params.K0, params.D0, model=cfg.distortion_model0, R=params.R_c0_c1)
    cguess = distort_points(xn, params.K1, params.D1, model=cfg.distortion_model1).reshape(B * C, 2)
    cand_flat, cvalid_flat = cand_xy.reshape(B * C, 2), cand_valid.reshape(B * C)
    if L > 2:
        s = 4.0  # scale of pyramid level 2
        res_c = klt(pyr0[2:], pyr1[2:], cand_flat / s, cguess / s, cvalid_flat, img_index=idx_c, **kw)
        cguess = res_c.pts * s
    sl = max(1, min(cfg.stereo_levels, L))
    # The candidates' walk of the levels between the coarse pair and the
    # shared fine levels (level 1 by default; cand_level1=False skips it).
    for lvl in range(min(2, L) - 1, sl - 1, -1):
        if lvl == 1 and not cfg.cand_level1:
            continue
        s = float(2**lvl)
        res_m = klt(pyr0[lvl:lvl + 1], pyr1[lvl:lvl + 1], cand_flat / s, cguess / s, cvalid_flat,
                    img_index=idx_c, **kw)
        cguess = res_m.pts * s

    n_surv = B * N
    pts0 = torch.cat([pts_surv.reshape(n_surv, 2), cand_flat], dim=0)
    guess = torch.cat([surv_guess.reshape(n_surv, 2), cguess], dim=0)
    valid = torch.cat([surv_valid.reshape(n_surv), cvalid_flat], dim=0)
    idx = torch.cat([lane_index(B, N, dev), idx_c])
    sp_all = rt2 = me_all = None
    n_anchor = torch.zeros((B,), dtype=torch.int32, device=dev)
    if _fused_stereo_active(cfg, img_shape):
        pts0, acc, res, rt2, sp_all, me_all = stereo_anchor_lr_fused(
            pyr0[0], pyr1[0], pts0, guess, valid, **kw,
            anchor_sp=None if anchor_sp is None else anchor_sp.reshape((n_surv,) + anchor_sp.shape[2:]),
            anchor_valid=surv_valid.reshape(n_surv) if anchor_sp is not None else None,
            anchor_radius=cfg.anchor_radius,
            norm=norm,
            anchor_norm=anchor_norm,
            img_index=idx,
        )
        if acc is not None:
            n_anchor = torch.sum(acc.reshape(B, N), dim=1).to(torch.int32)
        if not _tmpl_carry_active(cfg):
            sp_all = None  # nothing maintains the carried templates
    elif _tmpl_carry_active(cfg):
        res, sp_all = optical_flow_lk_corr_l0(
            pyr0[0], pyr1[0], pts0, guess, valid, **kw, want_tmpl=True, norm=norm, img_index=idx
        )
    else:
        res = klt(pyr0[:sl], pyr1[:sl], pts0, guess, valid, img_index=idx, **kw)
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

    # Left-right round trip: inside the fused call, or a backward pass over
    # the union ([lo:] skips the survivors without stereo_lr_survivors).
    if rt2 is not None:
        ok = ok & (rt2 <= cfg.stereo_lr_threshold**2)
    elif cfg.stereo_lr_threshold > 0:
        lo = 0 if cfg.stereo_lr_survivors else n_surv
        res_b = klt(pyr1[:1], pyr0[:1], pts1[lo:], pts0[lo:], ok[lo:], img_index=idx[lo:], **kw)
        rt2_u = torch.sum((res_b.pts - pts0[lo:]) ** 2, dim=1)
        ok_lr = ok[lo:] & res_b.valid & (rt2_u <= cfg.stereo_lr_threshold**2)
        ok = torch.cat([ok[:lo], ok_lr], dim=0)

    def surv(x):
        return None if x is None else x[:n_surv].reshape((B, N) + x.shape[1:])

    def cand(x):
        return None if x is None else x[n_surv:].reshape((B, C) + x.shape[1:])

    return (
        (surv(pts0), surv(pts1), surv(ok), surv(depth)),
        (cand(pts1), cand(ok), cand(depth)),
        (surv(sp_all), cand(sp_all)),
        n_anchor,
        (surv(me_all), cand(me_all)),
    )


def _allocate_new_features(
    state: TrackerState, cand_xy, cand_score, cand_pts1, cand_ok,
    cfg: FrontendConfig, img_shape, fill_to: int,
    cand_tmpl, cand_depth, cand_snr,
) -> TrackerState:
    """Fill grids below ``fill_to`` with stereo-matched candidates, per lane
    (pool (B, N), candidates (B, C)).  Without candidate templates
    (``cand_tmpl`` None) the new slots keep their old ``tmpl`` and
    ``anchor``, without ``cand_snr`` their old ``snr``, as in JAX."""
    N = cfg.max_features
    G = cfg.num_grids
    dev = cand_xy.device
    B = cand_xy.shape[0]
    pool_grid = _grid_code(state.pts0, img_shape, cfg)
    pool_count = count_into(torch.where(state.fid >= 0, pool_grid, torch.full_like(pool_grid, G)), G)
    vacancy = torch.clamp(fill_to - pool_count, min=0)

    cgrid = _grid_code(cand_xy, img_shape, cfg)
    crank = _rank_within_group(cgrid, -cand_score, cand_ok, G)
    accept = cand_ok & (crank < torch.take_along_dim(vacancy, cgrid, dim=1))

    free = state.fid < 0
    free_rank = torch.cumsum(free.to(torch.int64), 1) - 1
    slot_of_rank = scatter_drop(
        torch.full((B, N), N, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, torch.full_like(free_rank, N)),
        torch.arange(N, device=dev).expand(B, N),
    )
    n_free = torch.sum(free, dim=1, keepdim=True)
    acc_rank = torch.cumsum(accept.to(torch.int64), 1) - 1
    placed = accept & (acc_rank < n_free)
    target = torch.where(
        placed, torch.take_along_dim(slot_of_rank, torch.clamp(acc_rank, 0, N - 1), dim=1),
        torch.full_like(acc_rank, N),
    )

    new_fid = state.next_fid[:, None] + acc_rank.to(torch.int32)
    n_added = torch.sum(placed, dim=1).to(torch.int32)

    def fill(x, val):
        return x if val is None else scatter_drop(x, target, val)

    return state._replace(
        pts0=scatter_drop(state.pts0, target, cand_xy),
        pts1=scatter_drop(state.pts1, target, cand_pts1),
        fid=scatter_drop(state.fid, target, new_fid),
        lifetime=scatter_drop(state.lifetime, target, 1),
        response=scatter_drop(state.response, target, cand_score.to(state.response.dtype)),
        next_fid=state.next_fid + n_added,
        tmpl=fill(state.tmpl, cand_tmpl),
        depth=scatter_drop(state.depth, target, cand_depth.to(state.depth.dtype)),
        # The candidate's stereo template is its birth appearance: the anchor.
        anchor=fill(state.anchor, cand_tmpl),
        snr=fill(state.snr, cand_snr),
    )


def _prune_grid_features(state: TrackerState, cfg: FrontendConfig, img_shape) -> TrackerState:
    """Cap each grid of each lane at grid_max_feature_num, keeping the
    longest-lived."""
    grid = _grid_code(state.pts0, img_shape, cfg)
    rank = _rank_within_group(grid, -state.lifetime, state.fid >= 0, cfg.num_grids)
    keep = rank < cfg.grid_max_feature_num
    return state._replace(fid=torch.where(keep, state.fid, torch.full_like(state.fid, -1)))


def _publish(state: TrackerState, params: FrontendParams, cfg: FrontendConfig, dtype):
    """Undistort to normalized coordinates and emit the measurement set."""
    un0 = undistort_points(state.pts0, params.K0, params.D0, model=cfg.distortion_model0)
    un1 = undistort_points(state.pts1, params.K1, params.D1, model=cfg.distortion_model1)
    uv = torch.cat([un0, un1], dim=-1).to(dtype)
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
    cam_vel: Optional[torch.Tensor] = None,
):
    """One stereo frame of one sequence through the tracker: the one-lane
    view of ``batched_frontend_step``.  Returns (state, FrameOutput)."""
    state, out = batched_frontend_step(
        add_lane_axis(state), add_lane_axis(pyr0_prev), add_lane_axis(pyr0_curr),
        add_lane_axis(pyr1_curr), mean_gyro[None], dt[None], is_first[None], params, cfg,
        None if cam_vel is None else cam_vel[None],
    )
    return drop_lane_axis(state), drop_lane_axis(out)


def batched_frontend_step(
    state: TrackerState,
    pyr0_prev: Sequence[torch.Tensor],
    pyr0_curr: Sequence[torch.Tensor],
    pyr1_curr: Sequence[torch.Tensor],
    mean_gyro: torch.Tensor,
    dt: torch.Tensor,
    is_first: torch.Tensor,
    params: FrontendParams,
    cfg: FrontendConfig,
    cam_vel: Optional[torch.Tensor] = None,
):
    """One stereo frame of B sequences through the tracker: ``state`` with
    a leading lane axis, pyramid levels (B, h, w) (a broadcast view where
    the lanes share an image), ``mean_gyro`` (B, 3), ``dt`` (B,),
    ``is_first`` (B,), ``cam_vel`` (B, 3), the cam0-frame velocity for the
    translation-aware temporal prediction, or None for the reference's
    rotation-only warp.  Returns (state, FrameOutput), the counters (B,)."""
    with matmul_precision_scope(cfg.matmul_precision):
        return _frontend_step_impl(
            state, pyr0_prev, pyr0_curr, pyr1_curr, mean_gyro, dt, is_first,
            params, cfg, cam_vel,
        )


def _mat3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices as elementwise products and sums, so
    never in TF32; under a bf16 name the product of the passes, as JAX's
    dot there."""
    passes = precision.active_passes()
    if passes:
        return precision.matmul(A, B, passes)
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _rotation_warp(pts: torch.Tensor, K: torch.Tensor, R_p_c: torch.Tensor) -> torch.Tensor:
    """The IMU-predicted homography K R_p_c K^-1 applied to pixel points
    (B, N, 2) (the reference's rotation-only predictFeatureTracking), in
    elementwise float arithmetic, or under a bf16 name in the passes'
    products (JAX's dots)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    Km = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]), torch.stack([zero, zero, one])])
    Kinv = torch.stack([
        torch.stack([1 / fx, zero, -cx / fx]), torch.stack([zero, 1 / fy, -cy / fy]), torch.stack([zero, zero, one]),
    ])
    Hm = _mat3(_mat3(Km.to(pts.dtype), R_p_c), Kinv.to(pts.dtype))  # (B, 3, 3)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    passes = precision.active_passes()
    if passes:
        warped = precision.matmul(ph, Hm.transpose(-1, -2), passes)
    else:
        warped = torch.sum(ph[..., None, :] * Hm[:, None, :, :], dim=-1)
    return warped[..., :2] / warped[..., 2:3]


def _frontend_step_impl(
    state, pyr0_prev, pyr0_curr, pyr1_curr, mean_gyro, dt, is_first, params, cfg, cam_vel
):
    img_shape = tuple(pyr0_curr[0].shape[-2:])
    H, W = img_shape
    B, N = state.fid.shape
    dev = state.fid.device
    before_tracking = torch.sum(state.fid >= 0, dim=1)
    kw = dict(win=cfg.patch_size, iters=cfg.max_iteration, eps=cfg.track_precision)
    idx = lane_index(B, N, dev)

    def flat(x):
        return x.reshape((B * N,) + x.shape[2:])

    # --- Temporal prediction: rotation only (cam_vel None), or each
    # track's last stereo depth moved by the camera's velocity over dt.
    w_cam = mean_gyro @ params.R_imu_cam0.T
    R_p_c = so3_exp(w_cam * dt[:, None]).transpose(-1, -2)
    if cam_vel is None:
        guess = _rotation_warp(state.pts0, params.K0, R_p_c)
        depth_ratio = torch.ones_like(state.depth)
    else:
        xn = undistort_points(state.pts0, params.K0, params.D0, model=cfg.distortion_model0)
        z0 = torch.where(state.depth > 0.3, state.depth, torch.full_like(state.depth, 1e6))
        X = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1) * z0[..., None]
        Xp = (X - cam_vel[:, None, :] * dt[:, None, None]) @ R_p_c.transpose(-1, -2)
        zc = torch.clamp(Xp[..., 2], min=0.3)
        guess = distort_points(Xp[..., :2] / zc[..., None], params.K0, params.D0, model=cfg.distortion_model0)
        depth_ratio = torch.clamp(z0 / zc, 0.5, 2.0)

    # --- Temporal tracking: the carried templates at level 0, or the
    # temporal_levels-level LK of klt_impl.
    active = state.fid >= 0
    norm, anchor_norm = _norms(cfg)
    carry = _tmpl_carry_active(cfg)
    with span("frontend.temporal_lk"):
        if carry:
            res, _ = optical_flow_lk_corr_l0(
                pyr0_prev[0], pyr0_curr[0], flat(state.pts0), flat(guess), flat(active), **kw,
                tmpl_sp=flat(state.tmpl), norm=norm, img_index=idx,
            )
        else:
            tl = max(1, min(cfg.temporal_levels, len(pyr0_prev)))
            res = _klt_fn(cfg.klt_impl, norm)(
                pyr0_prev[:tl], pyr0_curr[:tl], flat(state.pts0), flat(guess), flat(active), img_index=idx, **kw
            )
    tracked_pts0 = res.pts.reshape(B, N, 2)
    tracked = active & res.valid.reshape(B, N)
    tracked = tracked & (tracked_pts0[..., 0] >= 0) & (tracked_pts0[..., 0] <= W - 1)
    tracked = tracked & (tracked_pts0[..., 1] >= 0) & (tracked_pts0[..., 1] <= H - 1)

    # --- Anchor refinement against the birth templates: inside the fused
    # stereo call where it runs, else a standalone level-0 call here.
    fused = _fused_stereo_active(cfg, img_shape)
    anchor_on = cfg.anchor_refine and carry
    n_anchor = torch.zeros((B,), dtype=torch.int32, device=dev)
    if anchor_on and not fused:
        res_a, _ = optical_flow_lk_corr_l0(
            pyr0_curr[0], pyr0_curr[0], flat(tracked_pts0), flat(tracked_pts0), flat(tracked), **kw,
            tmpl_sp=flat(state.anchor), norm=anchor_norm, img_index=idx,
        )
        pa = res_a.pts.reshape(B, N, 2)
        corr2 = torch.sum((pa - tracked_pts0) ** 2, dim=-1)
        accept = tracked & res_a.valid.reshape(B, N) & (corr2 <= cfg.anchor_radius**2)
        tracked_pts0 = torch.where(accept[..., None], pa, tracked_pts0)
        n_anchor = torch.sum(accept, dim=1).to(torch.int32)
    after_tracking = torch.sum(tracked, dim=1)

    # --- New-feature candidates away from the tracked features.
    with span("frontend.fast"):
        cand_xy, cand_score, cand_valid = _detect_candidates(
            tracked_pts0, tracked, pyr0_curr[0], cfg, img_shape
        )

    # --- Stereo match of survivors and candidates.
    disparity_guess = tracked_pts0 + (state.pts1 - state.pts0) * depth_ratio[..., None]
    with span("frontend.stereo"):
        (
            (tracked_pts0, pts1, matched, surv_depth),
            (cand_pts1, cand_ok, cand_depth),
            (surv_tmpl, cand_tmpl),
            n_anchor_fused,
            (surv_snr, cand_snr),
        ) = _stereo_match_merged(
            pyr0_curr, pyr1_curr, tracked_pts0, disparity_guess, tracked,
            cand_xy, cand_valid, params, cfg, img_shape,
            anchor_sp=state.anchor if (anchor_on and fused) else None,
        )
    n_anchor = n_anchor + n_anchor_fused  # at most one side is nonzero
    after_matching = torch.sum(matched, dim=1)

    # --- Optional temporal two-point RANSAC on both cameras.
    if cfg.ransac_enabled:
        with span("frontend.ransac"):
            R1_p_c = so3_exp((mean_gyro @ params.R_imu_cam1.T) * dt[:, None]).transpose(-1, -2)
            in0 = _ransac.two_point_ransac(
                state.pts0, tracked_pts0, matched, R_p_c, params.K0, params.D0,
                *_ransac.ransac_draws(state.next_fid, 0), cfg.distortion_model0, cfg.ransac_threshold,
            )
            in1 = _ransac.two_point_ransac(
                state.pts1, pts1, matched, R1_p_c, params.K1, params.D1,
                *_ransac.ransac_draws(state.next_fid, 1), cfg.distortion_model1, cfg.ransac_threshold,
            )
            matched = matched & in0 & in1

    surv = matched & ~is_first[:, None]
    state = state._replace(
        pts0=torch.where(surv[..., None], tracked_pts0, state.pts0),
        pts1=torch.where(surv[..., None], pts1, state.pts1),
        fid=torch.where(surv, state.fid, torch.full_like(state.fid, -1)),
        lifetime=torch.where(surv, state.lifetime + 1, torch.zeros_like(state.lifetime)),
        depth=torch.where(surv, surv_depth, torch.zeros_like(surv_depth)),
        tmpl=state.tmpl if surv_tmpl is None else torch.where(
            surv[..., None, None], surv_tmpl.to(state.tmpl.dtype), state.tmpl
        ),
        snr=state.snr if surv_snr is None else torch.where(
            surv, surv_snr.to(state.snr.dtype), torch.zeros_like(state.snr)
        ),
    )

    # --- Fill under-populated grids with matched candidates; prune.
    with span("frontend.allocate"):
        state = _allocate_new_features(
            state, cand_xy, cand_score, cand_pts1, cand_ok, cfg, img_shape,
            cfg.grid_min_feature_num, cand_tmpl, cand_depth, cand_snr,
        )
    with span("frontend.prune"):
        state = _prune_grid_features(state, cfg, img_shape)

    with span("frontend.publish"):
        fid, uv, valid = _publish(state, params, cfg, state.pts0.dtype)
    out = FrameOutput(
        fid=fid, uv=uv, valid=valid,
        before_tracking=before_tracking,
        after_tracking=after_tracking,
        after_matching=after_matching,
        after_ransac=torch.sum(valid, dim=1),
        anchor_accepted=n_anchor,
        quality=state.snr,
    )
    return state, out


def pyramids_for(img: torch.Tensor, cfg: FrontendConfig) -> Tuple[torch.Tensor, ...]:
    """Image pyramid for the tracker, of an (H, W) image or each image of a
    (B, H, W) stack; with cfg.presmooth the full-resolution level is the
    5-tap prefiltered image, coarse levels the raw pyrDown chain.  On the
    card ``cfg.pyramid_levels - 1`` launches of ``pyramid_level`` (one where
    a presmoothed pyramid has one level)."""
    return tuple(tracker_pyramid(img, cfg.pyramid_levels, cfg.presmooth))


def feature_lifetime_statistics(state: TrackerState) -> dict:
    """Lifetime statistics over one sequence's live pool (the reference's
    disabled featureLifetimeStatistics, kept as a diagnostic); reads the
    pool back to the host."""
    lt = state.lifetime.cpu().numpy()[state.fid.cpu().numpy() >= 0]
    if lt.size == 0:
        return {"count": 0}
    return {
        "count": int(lt.size),
        "mean": float(lt.mean()),
        "median": float(np.median(lt)),
        "max": int(lt.max()),
        "histogram": np.bincount(lt).tolist(),
    }
