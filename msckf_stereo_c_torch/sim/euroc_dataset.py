"""Write a synthetic sequence as a EuRoC MAV ``mav0/`` directory.

The layout is the one ``io/euroc.py:load_sequence`` reads and
``tests/test_euroc_io.py:fake_euroc`` writes: ``cam0/`` and ``cam1/`` with
``data.csv`` (nanosecond timestamp, file name) and ``data/<ns>.png``,
``imu0/data.csv`` (timestamp, gyro xyz, acc xyz) and
``state_groundtruth_estimate0/data.csv`` (timestamp, position, identity
quaternion w, x, y, z) at the frame times.  Times are offset by an epoch
base in nanoseconds, as real EuRoC times are.  The PNGs are written by
``io/png.py:encode_png``, their rows cycling through the five PNG
filters, so a reader meets every one.
"""
from __future__ import annotations

import os

import numpy as np

from ..io.png import encode_png

EUROC_EPOCH_NS = 1403636579758555520  # a EuRoC epoch base (tests/test_euroc_io.py)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """A rendered float image as the 8-bit pixels a camera would store."""
    return np.clip(np.rint(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)


def write_euroc(
    root: str,
    frame_t: np.ndarray,
    img0: np.ndarray,
    img1: np.ndarray,
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    gt_p: np.ndarray,
) -> str:
    """Write frames (T, H, W) at ``frame_t`` seconds, the IMU stream and the
    ground-truth positions (T, 3) under ``root/mav0``; returns that path."""
    mav0 = os.path.join(root, "mav0")

    def ns(t: float) -> int:
        return EUROC_EPOCH_NS + int(round(float(t) * 1e9))

    def row(*vecs) -> str:
        return ",".join(repr(float(x)) for v in vecs for x in v)

    os.makedirs(os.path.join(mav0, "imu0"), exist_ok=True)
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, g, a in zip(imu_t, imu_gyro, imu_acc):
            f.write(f"{ns(t)},{row(g, a)}\n")
    for cam, imgs in (("cam0", img0), ("cam1", img1)):
        os.makedirs(os.path.join(mav0, cam, "data"), exist_ok=True)
        with open(os.path.join(mav0, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t, img in zip(frame_t, imgs):
                name = f"{ns(t)}.png"
                encode_png(os.path.join(mav0, cam, "data", name), to_uint8(img), (0, 1, 2, 3, 4))
                f.write(f"{ns(t)},{name}\n")
    os.makedirs(os.path.join(mav0, "state_groundtruth_estimate0"), exist_ok=True)
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, p in zip(frame_t, gt_p):
            f.write(f"{ns(t)},{row(p)},1,0,0,0\n")
    return mav0
