# Frozen copy of msckf_stereo_c_torch/io/tum.py at commit 50013dad8c92.
"""TUM-format trajectory IO and ATE evaluation.

The reference writes TUM lines to ``pose_out.txt`` (msckf_vio.cpp:1256-1258)
and is evaluated externally with TUM rgbd_benchmark_tools
(reference README.md:53-88).  This module provides both halves in-repo: the
writer and the absolute-trajectory-error metric with Horn/Umeyama SE(3)
alignment (matching ``evaluate_ate.py --align`` semantics)."""
from __future__ import annotations

import dataclasses

import numpy as np


def write_tum(path: str, times: np.ndarray, positions: np.ndarray, quats_xyzw: np.ndarray):
    """One line per pose: ``t x y z qx qy qz qw``."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_xyzw):
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_tum(path: str):
    data = np.loadtxt(path, comments="#")
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (TUM associate.py semantics)."""
    idx_b = np.searchsorted(t_b, t_a)
    idx_b = np.clip(idx_b, 1, len(t_b) - 1)
    left = np.abs(t_b[idx_b - 1] - t_a)
    right = np.abs(t_b[idx_b] - t_a)
    nearest = np.where(left < right, idx_b - 1, idx_b)
    ok = np.abs(t_b[nearest] - t_a) <= max_dt
    return np.flatnonzero(ok), nearest[ok]


def horn_align(est: np.ndarray, gt: np.ndarray):
    """Closed-form SE(3) alignment est -> gt (Horn's method, no scale —
    matching TUM evaluate_ate.py ``align``).  Returns (R, t)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    W = E.T @ G
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


@dataclasses.dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    num_pairs: int


def evaluate_ate(
    est_t: np.ndarray,
    est_p: np.ndarray,
    gt_t: np.ndarray,
    gt_p: np.ndarray,
    max_dt: float = 0.02,
    align: bool = True,
) -> AteResult:
    """Absolute translational error after nearest-timestamp association and
    optional SE(3) alignment (TUM rgbd_benchmark_tools evaluate_ate)."""
    ia, ib = associate(est_t, gt_t, max_dt)
    e = est_p[ia]
    g = gt_p[ib]
    if not np.isfinite(e).all():
        # A diverged estimate (NaN/inf positions) must report as a huge
        # ATE, not crash the evaluation harness (Horn's SVD does not
        # converge on non-finite input — hit by a filter blow-up during
        # the round-5 klt_norm protocol).
        inf = float("inf")
        return AteResult(inf, inf, inf, inf, inf, inf, int(len(e)))
    if align and len(e) >= 3:
        R, t = horn_align(e, g)
        e = e @ R.T + t
    err = np.linalg.norm(e - g, axis=1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
        num_pairs=int(len(err)),
    )
