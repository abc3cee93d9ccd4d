"""Multi-session map alignment: the BASELINE config-5 tier (port of
``msckf_stereo_c_tpu/parallel/multisession.py``).

Two VIO sessions of the same space each live in their own gravity-aligned
odometry frame.  This module joins them: per-session keyframe BA problems
re-associate each session's tracks (``refine.py``), landmarks are matched
across sessions (mutual nearest neighbour under a coarse dock prior, swept
over the prior's weak axes), landmark-set Kabsch fits turn the matches into
inter-session relative-pose edges, and the joint pose graph (odometry
chains plus inter-session edges) is solved by the SE(3) solver
(``posegraph.py``) on the device, sharded over a process group when one is
given.  The alignment sweep's candidate clouds run as batches on the
device; the per-keyframe fits and the edge bookkeeping stay host numpy, as
in JAX.

Two faults of the JAX module are not carried over: ``_icp_passes`` commits
a pass's matches only when the pass meets ``min_matches``, and
``refine_alignment`` takes its sweep's half-ranges as arguments (JAX's
values by default) and warns when the winner sits on the grid's edge.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..io.tum import horn_align
from ..utils.quaternion import rot_to_jpl
from .collectives import resolve_group
from .posegraph import (
    PoseGraph,
    make_distributed_pose_graph,
    odometry_edges,
    optimize_pose_graph,
    shard_pose_graph,
)
from .refine import _rot

YAW_SWEEP_DEG, YAW_STEP_DEG = 24.0, 3.0  # JAX's sweep grid (multisession.py:160-198)
DZ_SWEEP_M, DZ_STEP_M = 2.0, 0.5
XY_SWEEP_M, XY_STEP_M = 1.6, 1.6


@dataclasses.dataclass
class SessionData:
    """One finished VIO session, keyframed for the joint problem."""

    kf_times: np.ndarray  # (F,)
    q: np.ndarray  # (F, 4) JPL world->body (the published xyzw reinterpreted)
    p: np.ndarray  # (F, 3) body position in the session's odometry frame
    landmarks: np.ndarray  # (L, 3) BA-triangulated, session frame
    lm_mask: np.ndarray  # (L, F) which keyframes observe each landmark


def _jpl(R: np.ndarray) -> np.ndarray:
    return rot_to_jpl(torch.as_tensor(np.array(R, np.float64))).numpy()


def session_frame_transform(q0_jpl: np.ndarray, R_w_b0: np.ndarray, p0_w: np.ndarray):
    """(R_wv, t_wv): the rigid map from a session's odometry frame V to the
    common world frame W, anchored at the session's start (dock) pose.
    ``q0_jpl`` is the JPL V->body quaternion of the filter's gravity init;
    (R_w_b0, p0_w) the session's true start pose in W (the dock prior).
    x_w = R_wv x_v + t_wv."""
    R_wv = np.asarray(R_w_b0).T @ _rot(q0_jpl)
    return R_wv, np.asarray(p0_w)


def relative_prior(
    frameA: Tuple[np.ndarray, np.ndarray],
    frameB: Tuple[np.ndarray, np.ndarray],
    yaw_noise_rad: float = 0.0,
    trans_noise_m: float = 0.0,
    seed: int = 0,
):
    """Coarse prior T_AB mapping session-B odometry coordinates into
    session A's frame, with operator-grade noise injected:
    x_A = R_ab x_B + t_ab."""
    (R_wa, t_wa), (R_wb, t_wb) = frameA, frameB
    R_ab = R_wa.T @ R_wb
    t_ab = R_wa.T @ (t_wb - t_wa)
    if yaw_noise_rad or trans_noise_m:
        rng = np.random.default_rng(seed)
        a = rng.normal(0.0, yaw_noise_rad)
        c, s = np.cos(a), np.sin(a)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        R_ab = Rz @ R_ab
        t_ab = t_ab + rng.normal(0.0, trans_noise_m, 3)
    return R_ab, t_ab


def apply_rigid(R: np.ndarray, t: np.ndarray, q: np.ndarray, p: np.ndarray):
    """Map world->body poses from frame B into frame A under x_A = R x_B + t:
    R'_vb = R_vb R^T, p' = R p + t."""
    Ra = np.einsum("fij,kj->fik", _rot(q), R)
    return _jpl(Ra), p @ R.T + t


def _mutual_nn(a: torch.Tensor, cur: torch.Tensor, radius: float):
    """Mutual nearest neighbours of ``a`` (La, 3) and each cloud of ``cur``
    (C, Lb, 3) within ``radius``: (nn_ab (C, La), keep (C, La) bool).  The
    squared distances sum x, y, z in numpy's order, so they are bit-equal
    to JAX's host computation, and argmin takes the first of equal
    minima, as numpy's does."""
    d2 = None
    for k in range(3):
        d = a[None, :, None, k] - cur[:, None, :, k]
        d2 = d * d if d2 is None else d2 + d * d  # (C, La, Lb)
    nn_ab = torch.argmin(d2, dim=2)
    nn_ba = torch.argmin(d2, dim=1)
    mutual = torch.gather(nn_ba, 1, nn_ab) == torch.arange(a.shape[0], device=a.device)
    close = torch.gather(d2, 2, nn_ab[..., None])[..., 0] <= radius * radius
    return nn_ab, mutual & close


def match_landmarks(lms_a: np.ndarray, lms_b_in_a: np.ndarray, radius: float = 0.5):
    """Mutual-nearest-neighbour 3D association within ``radius`` metres.
    Returns (idx_a, idx_b) match arrays."""
    if len(lms_a) == 0 or len(lms_b_in_a) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    a = torch.as_tensor(np.asarray(lms_a, np.float64))
    nn_ab, keep = _mutual_nn(a, torch.as_tensor(np.asarray(lms_b_in_a, np.float64))[None], radius)
    ia = np.flatnonzero(keep[0].numpy())
    return ia.astype(np.int32), nn_ab[0].numpy()[ia].astype(np.int32)


def _icp_batch(a: torch.Tensor, cur: torch.Tensor, radii, min_matches: int):
    """Mutual-NN + Kabsch passes at the radius schedule ``radii`` for C
    starting clouds ``cur`` (C, Lb, 3) at once against ``a`` (La, 3).
    A pass whose match count is under ``min_matches`` is skipped for that
    cloud: its matches, fit and rms stay those of the last pass that met
    it (identity, no matches and an infinite rms when none did).  Returns
    (R (C, 3, 3), t (C, 3), nn_ab (C, La), keep (C, La), rms (C,), last (C,)):
    the fit accumulated over the committed passes (x -> R x + t), the
    committed matches, and whether the last pass was committed."""
    C, La = cur.shape[0], a.shape[0]
    dt, dev = a.dtype, a.device
    R_acc = torch.eye(3, dtype=dt, device=dev).expand(C, 3, 3)
    t_acc = torch.zeros((C, 3), dtype=dt, device=dev)
    nn_ab = torch.zeros((C, La), dtype=torch.int64, device=dev)
    keep = torch.zeros((C, La), dtype=torch.bool, device=dev)
    rms = torch.full((C,), float("inf"), dtype=dt, device=dev)
    for r in radii:
        nn, kp = _mutual_nn(a, cur, r)
        n = kp.sum(dim=1)
        ok = n >= min_matches
        w = kp.to(dt)[..., None]
        nw = torch.clamp(n, min=1).to(dt)[:, None]
        est = torch.gather(cur, 1, nn[..., None].expand(C, La, 3))  # B point matched to each A point
        mu_e = (w * est).sum(dim=1) / nw
        mu_g = (w * a).sum(dim=1) / nw
        Wm = torch.einsum("cli,clj->cij", w * (est - mu_e[:, None]), a - mu_g[:, None])
        # Horn's method (io/tum.py:horn_align), batched.
        U, _, Vt = torch.linalg.svd(Wm)
        flip = torch.linalg.det(U) * torch.linalg.det(Vt) < 0
        S = torch.ones((C, 3), dtype=dt, device=dev)
        S[:, 2] = torch.where(flip, -1.0, 1.0)
        R = Vt.transpose(1, 2) @ (S[..., None] * U.transpose(1, 2))
        t = mu_g - (R @ mu_e[..., None])[..., 0]
        moved = cur @ R.transpose(1, 2) + t[:, None]
        res = torch.gather(moved, 1, nn[..., None].expand(C, La, 3)) - a
        rms_new = torch.sqrt((w[..., 0] * torch.sum(res * res, dim=-1)).sum(dim=1) / nw[:, 0])
        cur = torch.where(ok[:, None, None], moved, cur)
        R_acc = torch.where(ok[:, None, None], R @ R_acc, R_acc)
        t_acc = torch.where(ok[:, None], (R @ t_acc[..., None])[..., 0] + t, t_acc)
        nn_ab = torch.where(ok[:, None], nn, nn_ab)
        keep = torch.where(ok[:, None], kp, keep)
        rms = torch.where(ok, rms_new, rms)
    return R_acc, t_acc, nn_ab, keep, rms, ok


def _matches(nn_ab: torch.Tensor, keep: torch.Tensor):
    """One cloud's committed matches as (idx_a, idx_b) int32 arrays."""
    ia = np.flatnonzero(keep.cpu().numpy())
    return ia.astype(np.int32), nn_ab.cpu().numpy()[ia].astype(np.int32)


def _icp_passes(lms_a, cur, radii, min_matches, device="cpu"):
    """Mutual-NN + Kabsch passes of one cloud (``_icp_batch`` with C = 1)
    as numpy: (R, t, ia, ib, rms) over the passes that met
    ``min_matches``."""
    a = torch.as_tensor(np.asarray(lms_a, np.float64), device=device)
    c = torch.as_tensor(np.asarray(cur, np.float64), device=device)[None]
    R, t, nn_ab, keep, rms, _ = _icp_batch(a, c, radii, min_matches)
    ia, ib = _matches(nn_ab[0], keep[0])
    return R[0].cpu().numpy(), t[0].cpu().numpy(), ia, ib, float(rms[0])


def _grid(half: float, step: float) -> np.ndarray:
    """The multiples of ``step`` that cover [-half, half] (JAX's grids at
    JAX's half-ranges)."""
    n = int(np.ceil(half / step - 1e-9)) if half > 0 else 0
    return step * np.arange(-n, n + 1)


def refine_alignment(
    lms_a: np.ndarray,
    lms_b_in_a: np.ndarray,
    radius_schedule: Tuple[float, ...] = (3.0, 1.5, 0.8, 0.4),
    min_matches: int = 12,
    yaw_sweep_deg: float = YAW_SWEEP_DEG,
    yaw_step_deg: float = YAW_STEP_DEG,
    dz_sweep_m: float = DZ_SWEEP_M,
    xy_sweep_m: float = XY_SWEEP_M,
    device=None,
):
    """Global alignment refinement of the coarse dock prior: a sweep over
    yaw, x, y and z offsets (about the B cloud's centroid), each candidate
    scored by ICP over the full radius schedule (a last pass that met
    ``min_matches`` first, then its match count, then -rms; the first best
    in the grid's order wins), then JAX's steps from the winner: short ICP
    (the first three radii) and mutual-NN + global Kabsch passes (point-set
    ICP) with the full schedule.

    Both session frames are gravity-aligned, so the prior's error is mostly
    yaw and z, the axes along which ICP's basin is narrow in a room-shaped
    map; the sweep restores the basin.  The half-ranges (``yaw_sweep_deg``,
    ``dz_sweep_m``, ``xy_sweep_m``) should cover the prior's noise; the
    steps are JAX's.  JAX scores its candidates after the first three radii
    only, where, in a grid widened to cover the prior, self-consistent
    wrong basins can outscore the true one; the score at the last radius
    separates them.  When the result's yaw correction or centroid shift
    lies nearer a grid axis's outermost point than its next one, a warning
    line is printed: the true alignment may lie outside the grid.  The
    candidates run as batches of clouds on ``device`` (the CUDA card when
    None).

    Returns (R, t, idx_a, idx_b): x_A = R x + t maps prior-aligned B
    coordinates into A; the final matches feed ``intersession_edges``."""
    device = resolve_device(device)
    yaws = np.deg2rad(_grid(yaw_sweep_deg, yaw_step_deg))
    dzs = _grid(dz_sweep_m, DZ_STEP_M)
    xys = _grid(xy_sweep_m, XY_STEP_M)
    grid = np.stack([g.reshape(-1) for g in np.meshgrid(yaws, xys, xys, dzs, indexing="ij")], axis=1)

    a = torch.as_tensor(np.asarray(lms_a, np.float64), device=device)
    b = torch.as_tensor(np.asarray(lms_b_in_a, np.float64), device=device)
    cB = b.mean(dim=0)
    c, s = np.cos(grid[:, 0]), np.sin(grid[:, 0])
    zero, one = np.zeros_like(c), np.ones_like(c)
    Rz = torch.as_tensor(np.stack([c, -s, zero, s, c, zero, zero, zero, one], 1).reshape(-1, 3, 3), device=device)
    t0 = cB - (Rz @ cB) + torch.as_tensor(grid[:, 1:], device=device)

    # Batches of candidate clouds, ~2^26 distances each.
    step = max(1, (1 << 26) // max(1, a.shape[0] * b.shape[0]))
    best = None
    for s0 in range(0, len(grid), step):
        cur0 = b @ Rz[s0:s0 + step].transpose(1, 2) + t0[s0:s0 + step, None]
        *_, keep, rms, last = _icp_batch(a, cur0, radius_schedule, min_matches)
        # The first candidate of the lexicographic best (last, n, -rms).
        n = torch.where(last == last.max(), keep.sum(dim=1), -1)
        r = torch.where(n == n.max(), rms, float("inf"))
        k = int(torch.argmax(((n == n.max()) & (r == r.min())).to(torch.int8)))
        score = (bool(last[k]), int(n[k]), -float(rms[k]))
        if best is None or score > best[0]:
            best = (score, s0 + k)
    at = best[1]
    # JAX's steps from the winner: short ICP, then the full schedule.
    R1, t1, *_ = _icp_batch(a, (b @ Rz[at].T + t0[at])[None], radius_schedule[:3], min_matches)
    R_acc, t_acc = R1[0] @ Rz[at], R1[0] @ t0[at] + t1[0]
    R2, t2, nn_ab, keep, *_ = _icp_batch(a, (b @ R_acc.T + t_acc)[None], radius_schedule, min_matches)
    ia, ib = _matches(nn_ab[0], keep[0])
    R = (R2[0] @ R_acc).cpu().numpy()
    t = (R2[0] @ t_acc + t2[0]).cpu().numpy()
    c = cB.cpu().numpy()
    got = (np.rad2deg(np.arctan2(R[1, 0], R[0, 0])), *(R @ c + t - c))
    axes = (("yaw", np.rad2deg(yaws), yaw_step_deg), ("x", xys, XY_STEP_M), ("y", xys, XY_STEP_M),
            ("dz", dzs, DZ_STEP_M))
    edge = [name for (name, g, st), v in zip(axes, got) if len(g) > 1 and abs(v) > g.max() - st / 2]
    if edge:
        print(f"warning: refine_alignment's result lies at the sweep grid's edge in {', '.join(edge)} (yaw "
              f"{got[0]:+.1f} deg, centroid shift ({got[1]:+.2f}, {got[2]:+.2f}, {got[3]:+.2f}) m): the true "
              f"alignment may lie outside the grid", file=sys.stderr, flush=True)
    return R, t, ia, ib


def intersession_edges(
    sessA: SessionData,
    sessB: SessionData,
    match_a: np.ndarray,
    match_b: np.ndarray,
    min_common: int = 6,
    max_edges: int = 64,
    weight: float = 1.0,
):
    """Per-B-keyframe landmark-set Kabsch fits -> relative-pose edges.

    For each B keyframe observing >= ``min_common`` matched landmarks, the
    matched subsets (A-frame vs B-frame positions) give a local rigid fit
    T_loc (B->A); the edge ties that keyframe to the A keyframe co-observing
    most of the same landmarks, with the measured relative pose derived from
    T_loc and an information weight from the fit (residual rms, point count
    and the lever arm over the cloud's thinnest spread).  Nodes: A keyframes
    [0, Fa), B keyframes [Fa, Fa + Fb).  Returns (ei, ej, R_m, t_m, w)."""
    Fa = sessA.q.shape[0]
    Ra = _rot(sessA.q)
    Rb = _rot(sessB.q)
    ei, ej, R_ms, t_ms, ws = [], [], [], [], []
    order = np.argsort(-sessB.lm_mask[match_b].sum(axis=0))  # busiest kb first
    for kb in order:
        obs_here = sessB.lm_mask[match_b, kb]
        if obs_here.sum() < min_common:
            continue
        sel_a = match_a[obs_here]
        sel_b = match_b[obs_here]
        pts_a = sessA.landmarks[sel_a]
        pts_b = sessB.landmarks[sel_b]
        R_loc, t_loc = horn_align(pts_b, pts_a)
        ka = int(np.argmax(sessA.lm_mask[sel_a].sum(axis=0)))
        if sessA.lm_mask[sel_a, ka].sum() < min_common:
            continue
        # B keyframe pose mapped into A frame by the local fit.
        R_kb_a = Rb[kb] @ R_loc.T
        p_kb_a = R_loc @ sessB.p[kb] + t_loc
        ei.append(ka)
        ej.append(Fa + kb)
        R_ms.append(Ra[ka] @ R_kb_a.T)
        t_ms.append(Ra[ka] @ (p_kb_a - sessA.p[ka]))
        # var = rms^2 / n * (1 + lever^2 / lambda_min); w = 1 / var (rms
        # floored at 1 cm, lambda_min at 0.1 m^2).
        n_c = float(obs_here.sum())
        pts_b_a = pts_b @ R_loc.T + t_loc
        res = pts_a - pts_b_a
        rms2 = max(float(np.mean(np.sum(res * res, -1))), 1e-4)
        ctr = pts_b_a.mean(axis=0)
        C = pts_b_a - ctr
        lam_min = max(float(np.linalg.eigvalsh(C.T @ C / n_c)[0]), 1e-2)
        lever2 = float(np.sum((p_kb_a - ctr) ** 2))
        var = rms2 / n_c * (1.0 + lever2 / lam_min)
        ws.append(weight / var)
        if len(ei) >= max_edges:
            break
    if not ei:
        z = np.zeros(0)
        return z.astype(np.int32), z.astype(np.int32), np.zeros((0, 3, 3)), np.zeros((0, 3)), z
    return (
        np.asarray(ei, np.int32),
        np.asarray(ej, np.int32),
        np.stack(R_ms),
        np.stack(t_ms),
        np.asarray(ws),
    )


def build_joint_graph(
    sessA: SessionData,
    sessB_in_a: SessionData,
    inter: Tuple[np.ndarray, ...],
    odom_weight: float = 1.0e4,
    dtype=torch.float64,
    device=None,
) -> PoseGraph:
    """Joint pose graph on ``device`` (the CUDA card when None): both
    sessions' odometry chains plus the inter-session edges.  sessB poses
    must already be mapped into A's frame.  ``odom_weight`` is the odometry
    edges' information (1/variance; 1e4 ~ 1 cm between consecutive
    keyframes), on the inter-session edges' 1/variance scale."""
    device = resolve_device(device)
    Fa = sessA.q.shape[0]
    q = np.concatenate([sessA.q, sessB_in_a.q], axis=0)
    p = np.concatenate([sessA.p, sessB_in_a.p], axis=0)

    ei_a, ej_a, Rm_a, tm_a, w_a = odometry_edges(sessA.q, sessA.p, weight=odom_weight)
    ei_b, ej_b, Rm_b, tm_b, w_b = odometry_edges(sessB_in_a.q, sessB_in_a.p, weight=odom_weight)
    ei_x, ej_x, Rm_x, tm_x, w_x = inter

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return PoseGraph(
        q=t(q),
        p=t(p),
        edge_i=t(np.concatenate([ei_a, ei_b + Fa, ei_x]), torch.int64),
        edge_j=t(np.concatenate([ej_a, ej_b + Fa, ej_x]), torch.int64),
        R_meas=t(np.concatenate([Rm_a, Rm_b, Rm_x.reshape(-1, 3, 3)])),
        t_meas=t(np.concatenate([tm_a, tm_b, tm_x.reshape(-1, 3)])),
        weight=t(np.concatenate([w_a, w_b, w_x])),
    )


def optimize_joint(graph: PoseGraph, group=None, iters: int = 12):
    """The joint graph's Gauss-Newton solve: sharded over ``group``'s ranks
    when given (each rank takes its block of the edges, padded with
    zero-weight edges), else on one process."""
    if group is None:
        return optimize_pose_graph(graph, iters=iters)
    group, world, rank = resolve_group(group)
    refined, costs = make_distributed_pose_graph(group, iters=iters)(shard_pose_graph(graph, world, rank))
    return graph._replace(q=refined.q, p=refined.p), costs
