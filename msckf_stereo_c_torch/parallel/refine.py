"""VIO -> keyframe BA refinement glue (port of
``msckf_stereo_c_tpu/parallel/refine.py``).

Takes a finished VIO run (per-frame body poses and the front end's
published feature measurements) and assembles the keyframe BA problem:
subsampled keyframe camera poses, feature tracks re-associated across
keyframes by id, DLT-initialised landmarks and the observation tensor the
Schur-complement solver (``ba.py``) consumes.  The re-association and the
DLT run on the host in numpy, as in JAX; the problem goes to the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EUROC_CALIB, StereoCalib
from ..utils.quaternion import jpl_to_rot, rot_to_jpl
from .ba import BAProblem, ba_gauss_newton, make_distributed_ba, problem_from_vio, shard_ba_problem
from .collectives import resolve_group


def _rot(q: np.ndarray) -> np.ndarray:
    """JPL quaternions -> rotation matrices, in float64 on the host."""
    return jpl_to_rot(torch.as_tensor(np.array(q, np.float64))).numpy()


def _body_to_cam0(q_xyzw_ham: np.ndarray, p_body: np.ndarray, calib: StereoCalib):
    """Body (= IMU for EuRoC) poses -> cam0 (world->cam rotation, position)."""
    # Hamilton body->world quaternion == JPL world->body components.
    R_w_b = _rot(q_xyzw_ham)  # (T, 3, 3) world->body
    T_ci = calib.cam0.T_cam_imu_mat()
    R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
    R_w_c = np.einsum("ij,tjk->tik", R_ci, R_w_b)
    # cam0 position in world: p_b + R_bw @ cam0_pos_in_imu
    cam_in_imu = -R_ci.T @ t_ci
    p_c = p_body + np.einsum("tij,j->ti", R_w_b.transpose(0, 2, 1), cam_in_imu)
    return R_w_c, p_c


def _dlt_triangulate(R_w_c: np.ndarray, p_c: np.ndarray, uv: np.ndarray, mask: np.ndarray):
    """Linear multi-view triangulation per landmark (mono cam0 rays)."""
    L, F = mask.shape
    out = np.zeros((L, 3))
    ok = np.zeros(L, bool)
    for l in range(L):
        ks = np.flatnonzero(mask[l])
        if len(ks) < 2:
            continue
        A = []
        for k in ks:
            R = R_w_c[k]
            t = -R @ p_c[k]  # p_cam = R p_w + t
            u, v = uv[l, k, 0], uv[l, k, 1]
            P = np.concatenate([R, t[:, None]], axis=1)
            A.append(u * P[2] - P[0])
            A.append(v * P[2] - P[1])
        A = np.asarray(A)
        _, _, Vt = np.linalg.svd(A)
        h = Vt[-1]
        if abs(h[3]) < 1e-12:
            continue
        out[l] = h[:3] / h[3]
        # Cheirality over the observing cams.
        depths = np.einsum("kij,j->ki", R_w_c[ks], out[l]) - np.einsum(
            "kij,kj->ki", R_w_c[ks], p_c[ks]
        )
        ok[l] = bool((depths[:, 2] > 0.1).all())
    return out, ok


def build_ba_problem(
    times: np.ndarray,  # (T,)
    quats_xyzw: np.ndarray,  # (T, 4) published body->world Hamilton
    positions: np.ndarray,  # (T, 3) published body positions
    fids: np.ndarray,  # (T, N) front-end feature ids per frame
    uvs: np.ndarray,  # (T, N, 4) normalized stereo measurements
    valids: np.ndarray,  # (T, N)
    calib: StereoCalib = EUROC_CALIB,
    keyframe_stride: int = 5,
    max_keyframes: int = 40,
    min_obs: int = 3,
    max_landmarks: int = 512,
    dtype=torch.float64,
    device=None,
) -> Optional[BAProblem]:
    """The keyframe BA problem from VIO outputs, assembled on the host and
    put on ``device`` (the CUDA card when None); None when the run has too
    few keyframes or tracks."""
    kf = np.arange(0, len(times), keyframe_stride)[:max_keyframes]
    F = len(kf)
    if F < 3:
        return None

    R_w_c, p_c = _body_to_cam0(quats_xyzw[kf], positions[kf], calib)

    # Re-associate tracks by feature id across keyframes.
    obs_map = {}
    for j, t_idx in enumerate(kf):
        val = valids[t_idx]
        for n in np.flatnonzero(val):
            obs_map.setdefault(int(fids[t_idx, n]), {})[j] = uvs[t_idx, n]
    items = [(fid, o) for fid, o in obs_map.items() if len(o) >= min_obs]
    items.sort(key=lambda kv: -len(kv[1]))
    items = items[:max_landmarks]
    if len(items) < 8:
        return None
    L = len(items)

    obs = np.zeros((L, F, 4))
    mask = np.zeros((L, F), bool)
    for l, (_, o) in enumerate(items):
        for j, z in o.items():
            obs[l, j] = z
            mask[l, j] = True

    lms, ok = _dlt_triangulate(R_w_c, p_c, obs, mask)
    obs = obs[ok]
    mask = mask[ok]
    lms = lms[ok]
    if len(lms) < 8:
        return None

    T01 = calib.T_cam0_cam1_mat()
    cam_q = rot_to_jpl(torch.as_tensor(R_w_c)).numpy()
    return problem_from_vio(
        cam_q, p_c, lms, obs, mask, T01[:3, :3], T01[:3, 3], dtype=dtype, device=device
    )


def refine_trajectory(problem: BAProblem, iters: int = 8, group=None):
    """Batch BA of ``problem``, on one process or, with ``group``, sharded
    over its ranks (each rank holds the whole problem and solves its
    landmark block; the refined landmarks are gathered back).  Returns the
    refined problem and the costs."""
    if group is None:
        return ba_gauss_newton(problem, iters=iters)
    group, world, rank = resolve_group(group)
    refined, costs = make_distributed_ba(group, iters=iters)(shard_ba_problem(problem, world, rank))
    blocks = [torch.empty_like(refined.landmarks) for _ in range(world)]
    torch.distributed.all_gather(blocks, refined.landmarks, group=group)
    L = problem.landmarks.shape[0]
    return refined._replace(landmarks=torch.cat(blocks)[:L], obs=problem.obs, mask=problem.mask), costs


def problem_to_body_poses(problem: BAProblem, calib: StereoCalib = EUROC_CALIB) -> np.ndarray:
    """BA cam0 poses -> body (IMU) positions, for ATE against the VIO and
    ground-truth body trajectories (host numpy)."""
    R_w_c = _rot(problem.cam_q.detach().cpu().numpy())  # (F, 3, 3)
    p_c = problem.cam_p.detach().cpu().numpy()
    T_ci = calib.cam0.T_cam_imu_mat()
    R_ci, t_ci = T_ci[:3, :3], T_ci[:3, 3]
    cam_in_imu = -R_ci.T @ t_ci
    R_w_b = np.einsum("ij,tjk->tik", R_ci.T, R_w_c)
    return p_c - np.einsum("tij,j->ti", R_w_b.transpose(0, 2, 1), cam_in_imu)
