"""The one general generator: a cell's inputs from its configuration file,
its cell file and ``--seed``.

Every lane runs the stress trajectory (``make_stress_trajectory``) from its
start, over the cell's ``seq_frames`` frames of its frame clock.  The cell
renders ``fields`` landmark fields on the device, and lane b reads field
b mod ``fields``; field f's draw seed is ``seed * fields + f``, from which
it draws its landmarks (with the protocol's landmark seed) and, under the
stress schedule, its sensor noise; lane b draws its IMU noise with
``seed * lanes + b``.  So one seed gives one set of inputs, and every seed
the same sizes, frames and lanes."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .render_torch import StressEvents, TorchRenderer, make_stress_events
from .trajectory import make_room_landmarks, make_stress_trajectory, synthesize_imu


def protocol_lm_seed(seed: int) -> int:
    """The multi-seed protocol's landmark seed (``msckf_stereo_c_torch/sim/
    stress.py:protocol_lm_seed`` at commit 50013dad8c92)."""
    return 1 if seed == 0 else 1000 + seed


@dataclasses.dataclass
class CellInputs:
    traj: object  # SimTrajectory
    frame_idx: np.ndarray  # (T,) trajectory samples of the sequence's frames
    img0: torch.Tensor  # (F, T, H, W) float32 on the device
    img1: torch.Tensor
    imu_t: np.ndarray  # (n,)
    gyro: np.ndarray  # (B, n, 3) per lane
    acc: np.ndarray
    lane_field: np.ndarray  # (B,) the field each lane reads
    field_lm_seeds: List[int]
    field_noise_seeds: List[int]
    imu_seeds: List[int]

    @property
    def frame_t(self) -> np.ndarray:
        return self.traj.t[self.frame_idx]

    @property
    def gt_p(self) -> np.ndarray:
        return self.traj.p[self.frame_idx]


def make_cell_inputs(config: dict, cell: dict, seed: int, calib, device) -> CellInputs:
    """Render the cell's fields on ``device`` and draw its lanes' IMU
    streams; ``calib`` is the frozen reference's calibration."""
    sc = config["scene"]
    traj = make_stress_trajectory(duration=float(sc["duration"]))
    frame_idx = np.arange(0, traj.t.shape[0], int(sc["frame_stride"]))[: int(cell["seq_frames"])]
    if frame_idx.shape[0] != int(cell["seq_frames"]):
        raise ValueError(f"the trajectory holds {frame_idx.shape[0]} frames, the cell asks for {cell['seq_frames']}")
    B, F = int(cell["lanes"]), int(cell["fields"])
    T = frame_idx.shape[0]
    noise_seeds = [seed * F + f for f in range(F)]
    lm_seeds = [protocol_lm_seed(s) for s in noise_seeds]
    imu_seeds = [seed * B + b for b in range(B)]
    W, H = calib.cam0.resolution
    img0 = torch.empty((F, T, H, W), dtype=torch.float32, device=device)
    img1 = torch.empty_like(img0)
    for f in range(F):
        if sc["photometrics"] == "stress":
            ev = make_stress_events(traj, frame_idx, noise_seed=noise_seeds[f])
        elif sc["photometrics"] == "nominal":
            ev = StressEvents.nominal(T)
        else:
            raise ValueError(f"unknown photometrics {sc['photometrics']!r}")
        renderer = TorchRenderer(
            make_room_landmarks(num=int(sc["num_landmarks"]), radius=float(sc["r_wall"]), z_cap=float(sc["z_cap"]),
                                seed=lm_seeds[f]),
            calib, r_wall=float(sc["r_wall"]), z_cap=float(sc["z_cap"]), device=device,
        )
        for s0 in range(0, T, 64):
            s1 = min(s0 + 64, T)
            a, b = renderer.render_sequence(traj, frame_idx[s0:s1], ev.slice(s0, s1), chunk=64)
            img0[f, s0:s1] = a
            img1[f, s0:s1] = b
        del renderer
    imus = [synthesize_imu(traj, gyro_noise=float(sc["imu_gyro_noise"]), acc_noise=float(sc["imu_acc_noise"]),
                           seed=s) for s in imu_seeds]
    return CellInputs(
        traj=traj, frame_idx=frame_idx, img0=img0, img1=img1, imu_t=imus[0].t,
        gyro=np.stack([m.gyro for m in imus]), acc=np.stack([m.acc for m in imus]),
        lane_field=np.arange(B) % F, field_lm_seeds=lm_seeds, field_noise_seeds=noise_seeds, imu_seeds=imu_seeds,
    )
