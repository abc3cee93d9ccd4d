"""EuRoC MAV dataset loading (port of ``msckf_stereo_c_tpu/io/euroc.py``).

Host-side equivalent of the reference app's dataset parsing
(apps/run_euroc_single_thread.cpp:151-238): reads ``mav0/camN/data.csv``
(nanosecond timestamps + PNG filenames), ``mav0/imu0/data.csv`` (gyro xyz,
acc xyz), and ``state_groundtruth_estimate0/data.csv`` when present.
Timestamps convert ns -> s in float64 and stay float64 on the host.

``ImageSource`` decodes the PNGs with the native runtime's prefetching
stream where that library builds (``io/native.py``) and with the zlib
decoder of ``io/png.py`` where it does not; both give exactly OpenCV's
pixels.  Which one runs is ``ImageSource.backend``, never silent.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional

import numpy as np

from . import native, png


@dataclasses.dataclass
class EurocImu:
    t: np.ndarray  # (N,) seconds
    gyro: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)


@dataclasses.dataclass
class EurocCamIndex:
    t: np.ndarray  # (N,) seconds
    files: List[str]  # absolute PNG paths


@dataclasses.dataclass
class EurocGroundTruth:
    t: np.ndarray
    p: np.ndarray  # (N, 3)
    q_wxyz: np.ndarray  # (N, 4) Hamilton w,x,y,z (EuRoC convention)


@dataclasses.dataclass
class EurocSequence:
    cam0: EurocCamIndex
    cam1: EurocCamIndex
    imu: EurocImu
    gt: Optional[EurocGroundTruth]


def _read_csv(path: str):
    with open(path) as f:
        return [r for r in csv.reader(f) if r and not r[0].startswith("#")]


def load_sequence(mav0_dir: str) -> EurocSequence:
    """``mav0_dir`` points at .../<sequence>/mav0 (argv[1] of the reference
    apps)."""

    def cam(which: str) -> EurocCamIndex:
        d = os.path.join(mav0_dir, which)
        rows = _read_csv(os.path.join(d, "data.csv"))
        t = np.array([int(r[0]) for r in rows], np.int64) * 1e-9
        files = [os.path.join(d, "data", r[1].strip()) for r in rows]
        return EurocCamIndex(t=t, files=files)

    rows = _read_csv(os.path.join(mav0_dir, "imu0", "data.csv"))
    t = np.array([int(r[0]) for r in rows], np.int64) * 1e-9
    gyro = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
    acc = np.array([[float(r[4]), float(r[5]), float(r[6])] for r in rows])

    gt = None
    gt_csv = os.path.join(mav0_dir, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        rows = _read_csv(gt_csv)
        gt_t = np.array([int(r[0]) for r in rows], np.int64) * 1e-9
        gt_p = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
        gt_q = np.array([[float(r[4]), float(r[5]), float(r[6]), float(r[7])] for r in rows])
        gt = EurocGroundTruth(t=gt_t, p=gt_p, q_wxyz=gt_q)

    return EurocSequence(cam0=cam("cam0"), cam1=cam("cam1"), imu=EurocImu(t=t, gyro=gyro, acc=acc), gt=gt)


def synchronize_stereo(seq: EurocSequence, max_dt: float = 0.004):
    """Pair cam0/cam1 frames by timestamp (EuRoC is hardware-synced; the
    reference assumes index-aligned lists).  Returns (times, files0, files1)."""
    i1 = np.searchsorted(seq.cam1.t, seq.cam0.t)
    i1 = np.clip(i1, 0, len(seq.cam1.t) - 1)
    prev = np.clip(i1 - 1, 0, len(seq.cam1.t) - 1)
    pick = np.where(
        np.abs(seq.cam1.t[prev] - seq.cam0.t) < np.abs(seq.cam1.t[i1] - seq.cam0.t),
        prev,
        i1,
    )
    ok = np.abs(seq.cam1.t[pick] - seq.cam0.t) <= max_dt
    idx0 = np.flatnonzero(ok)
    return (
        seq.cam0.t[idx0],
        [seq.cam0.files[i] for i in idx0],
        [seq.cam1.files[i] for i in np.asarray(pick)[idx0]],
    )


def load_images(files: List[str], width: int = 752, height: int = 480) -> np.ndarray:
    """Decode grayscale PNGs into one (T, H, W) float32 array."""
    with ImageSource(files, width, height) as src:
        return src.next(len(files))


class ImageSource:
    """Sequential chunked image source.

    With the native runtime (``backend == 'native'``), ONE prefetching
    stream stays open across the whole run: its C++ worker threads decode
    ahead (bounded by ``prefetch``), so the PNGs for chunk N+1 are decoded
    while chunk N runs on the card and ``next(n)`` returns without waiting
    (the reference's producer/consumer pipeline,
    apps/run_euroc_muitl_threads.cpp:30-90, without its race).

    Without it (``backend == 'zlib'``; ``native.build_error()`` says why)
    each chunk is decoded when it is asked for, by ``io/png.py``, with the
    chunk's frames swept together."""

    def __init__(
        self,
        files: List[str],
        width: int = 752,
        height: int = 480,
        prefetch: int = 128,
        threads: int = 6,
    ):
        self._files = list(files)
        self._width, self._height = width, height
        self._pos = 0
        self._stream = None
        self.backend = "zlib"
        if native.available():
            self._stream = native.ImageStream(
                self._files, width, height, queue_depth=max(prefetch, 1), threads=threads
            )
            self.backend = "native"

    def next(self, count: int) -> np.ndarray:
        """The next ``count`` frames, in file order, as (count, H, W) f32."""
        count = min(count, len(self._files) - self._pos)
        files = self._files[self._pos : self._pos + count]
        if self._stream is not None:
            out = self._stream.next_batch(count).astype(np.float32)
            if self._stream.errors:
                raise IOError(f"{self._stream.errors} PNG decode failures")
        elif count == 0:
            out = np.zeros((0, self._height, self._width), np.float32)
        else:
            out = png.decode_pngs(files).astype(np.float32)
            if out.shape[1:] != (self._height, self._width):
                raise ValueError(f"{files[0]}: {out.shape[2]}x{out.shape[1]}, expected {self._width}x{self._height}")
        self._pos += count
        return out

    def close(self):
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
