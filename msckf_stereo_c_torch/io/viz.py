"""Offline trajectory / landmark visualization (a copy of
``msckf_stereo_c_tpu/io/viz.py``; numpy only, no tensors).

The reference renders live with Pangolin / a raw-GL X11 viewer
(apps/run_euroc_single_thread.cpp:131-148, glwindow/).  Headless, the
analog is artifact export: trajectory and landmark plots written to PNG,
plus the feature-track debug view the reference draws with OpenCV
(draw_features_stereo, apps/run_euroc_single_thread.cpp:27-114).
matplotlib and OpenCV are imported inside the functions that use them, so
the module imports on a host that has neither (the card's host lacks
both)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(
    out_path: str,
    est_p: np.ndarray,
    gt_p: Optional[np.ndarray] = None,
    landmarks: Optional[np.ndarray] = None,
    title: str = "trajectory",
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    ax = axes[0]
    ax.plot(est_p[:, 0], est_p[:, 1], "b-", label="estimate")
    if gt_p is not None:
        ax.plot(gt_p[:, 0], gt_p[:, 1], "g--", label="ground truth")
    if landmarks is not None:
        ax.plot(landmarks[:, 0], landmarks[:, 1], "k.", ms=1, alpha=0.3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)

    ax = axes[1]
    t = np.arange(len(est_p))
    ax.plot(t, est_p[:, 2], "b-", label="z estimate")
    if gt_p is not None:
        ax.plot(t, gt_p[:, 2], "g--", label="z gt")
    ax.set_xlabel("frame")
    ax.set_ylabel("z [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def draw_feature_tracks(
    out_path: str,
    img0: np.ndarray,
    img1: np.ndarray,
    pts0: np.ndarray,
    pts1: np.ndarray,
    valid: np.ndarray,
    grid=(4, 5),
):
    """Stereo debug view with grid overlay (reference draw_features_stereo)."""
    import cv2

    H, W = img0.shape
    canvas = np.concatenate([img0, img1], axis=1).astype(np.uint8)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    gh, gw = H // grid[0], W // grid[1]
    for r in range(1, grid[0]):
        cv2.line(canvas, (0, r * gh), (2 * W, r * gh), (64, 64, 64), 1)
    for c in range(1, grid[1]):
        for off in (0, W):
            cv2.line(canvas, (off + c * gw, 0), (off + c * gw, H), (64, 64, 64), 1)
    for i in np.flatnonzero(valid):
        p0 = tuple(np.round(pts0[i]).astype(int))
        p1 = tuple(np.round(pts1[i]).astype(int))
        cv2.circle(canvas, p0, 3, (0, 255, 0), -1)
        cv2.circle(canvas, (p1[0] + W, p1[1]), 3, (0, 200, 255), -1)
        cv2.line(canvas, p0, (p1[0] + W, p1[1]), (180, 120, 0), 1)
    cv2.imwrite(out_path, canvas)
