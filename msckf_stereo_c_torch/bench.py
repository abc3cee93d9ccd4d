"""The bench scene and configuration that the port's scripts and tests share.

The counterpart of the repository's ``bench.py`` for ``msckf_stereo_c_torch``:
its synthetic EuRoC-resolution scene (752x480 stereo, circle trajectory,
600 wall landmarks; ``bench_scene``), its configuration from its
``BENCH_*`` environment variables, read the same way (``bench_configs``),
and B lanes stepped over the scene with the images and the IMU shared
(``BatchRun``).  ``scripts/stage_split.py`` reads the knobs as the JAX
split scripts read bench.py's; ``scripts/fastmotion_precision.py``,
``chip_smoke.py`` and the CPU tests use the scene.

``BENCH_FRONTEND_PRECISION`` and ``BENCH_FILTER_PRECISION`` take every
name, the bf16 ones included; a filter setting the port does not cover
raises from ``models/msckf.py:check_supported``, and ``BENCH_UNROLL``,
which unrolls a ``lax.scan`` the port does not have, raises
``NotImplementedError``; nothing falls back.

The port is measured by ``bench_vio/`` (``BENCHMARK.json``'s cells), not
here.
"""
from __future__ import annotations

import os
import subprocess
from typing import Mapping, NamedTuple

import numpy as np
import torch

from .config import FilterConfig, FrontendConfig
from .models import msckf as _msckf
from .parallel.vio_multiseq import run_vio_batch
from .utils.lanes import map_tree


def _env_bool(env: Mapping[str, str], name: str, default: bool) -> bool:
    """bench.py's strict boolean knob: "0", "1" or unset."""
    raw = env.get(name)
    if raw is None:
        return default
    if raw not in ("0", "1"):
        raise SystemExit(f"{name} must be 0 or 1, got {raw!r}")
    return raw == "1"


def bench_configs(env: Mapping[str, str] = os.environ):
    """(FrontendConfig, FilterConfig, method) from bench.py's knobs, checked
    against what the port covers."""
    fcfg = FrontendConfig(
        temporal_levels=int(env.get("BENCH_TEMPORAL_LEVELS", "1")),
        klt_impl=env.get("BENCH_KLT", FrontendConfig.klt_impl),
        matmul_precision=env.get("BENCH_FRONTEND_PRECISION", FrontendConfig.matmul_precision),
        anchor_refine=_env_bool(env, "BENCH_ANCHOR_REFINE", FrontendConfig.anchor_refine),
        translation_seed=_env_bool(env, "BENCH_TRANSLATION_SEED", FrontendConfig.translation_seed),
        stereo_lr_threshold=float(env.get("BENCH_STEREO_LR", FrontendConfig.stereo_lr_threshold)),
        stereo_lr_survivors=_env_bool(env, "BENCH_STEREO_LR_SURVIVORS", FrontendConfig.stereo_lr_survivors),
        cand_level1=_env_bool(env, "BENCH_CAND_LEVEL1", FrontendConfig.cand_level1),
        klt_norm=env.get("BENCH_KLT_NORM", FrontendConfig.klt_norm),
    )
    mcfg = FilterConfig(
        ns_iters=int(env.get("BENCH_NS_ITERS", "10")),
        matmul_precision=env.get("BENCH_FILTER_PRECISION", "tensorfloat32"),
        noise_adaptive=_env_bool(env, "BENCH_NOISE_ADAPTIVE", FilterConfig.noise_adaptive),
    )
    method = env.get("BENCH_METHOD", "schur")
    if env.get("BENCH_UNROLL", "1") != "1":
        raise NotImplementedError("BENCH_UNROLL unrolls bench.py's lax.scan; the port steps frames in Python")
    _msckf.check_supported(mcfg, method)
    return fcfg, mcfg, method


class Scene(NamedTuple):
    traj: object
    imu: object
    frame_idx: np.ndarray
    img0: np.ndarray  # (T, H, W)
    img1: np.ndarray
    landmarks: np.ndarray

    @property
    def frame_t(self) -> np.ndarray:
        return self.traj.t[self.frame_idx]


def bench_scene(n_frames: int) -> Scene:
    """bench.py's scene: circle trajectory, 600 wall landmarks, IMU noise
    5e-4 / 5e-3, one stereo frame every 10 IMU samples."""
    from .sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from .sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=max(4.0, n_frames * 0.05 + 2.0))
    landmarks = make_wall_landmarks(num=600, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    frame_idx = np.arange(0, traj.t.shape[0], 10)[:n_frames]
    img0, img1 = render_stereo_sequence(traj, landmarks, frame_idx, r_wall=8.0)
    return Scene(traj, imu, frame_idx, img0, img1, landmarks)


class BatchRun(NamedTuple):
    """Everything one timed run needs, on the device: B broadcast initial
    states, the scene's images (T, H, W) and IMU batches shared by every
    lane."""

    states: object
    imgs0: torch.Tensor
    imgs1: torch.Tensor
    times: torch.Tensor  # (B, T)
    imu: object  # ImuBatch (B, T, L, ...)
    fparams: object
    mparams: object
    fcfg: FrontendConfig
    mcfg: FilterConfig
    method: str
    device: torch.device

    def __call__(self, n: int | None = None):
        """(states, poses, fronts, metrics) of one run over the scene, or
        over its first ``n`` frames."""
        n = self.times.shape[1] if n is None else n
        return run_vio_batch(
            self.states, self.imgs0[:n], self.imgs1[:n], self.times[:, :n], map_tree(lambda x: x[:, :n], self.imu),
            self.fparams, self.mparams, self.fcfg, self.mcfg, self.method, device=self.device,
        )


def card_description(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (``cpu``
    on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    index = device.index or 0
    return out[index].strip() if len(out) > index else f"{torch.cuda.get_device_name(index)}, power limit not read"
