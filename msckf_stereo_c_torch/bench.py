"""Headline benchmark of the port: full-pipeline VIO throughput on one card.

    python -m msckf_stereo_c_torch.bench

The counterpart of the repository's ``bench.py`` for ``msckf_stereo_c_torch``:
the same synthetic EuRoC-resolution scene (752x480 stereo, circle
trajectory, 600 wall landmarks), the same configuration, and B independent
sequences stepped together (``parallel.vio_multiseq.run_vio_batch``) with
the images and the IMU shared by every lane and the states broadcast.  One
warm-up run, then ``BENCH_REPS`` timed runs with the card synchronised.

Prints ONE JSON line on stdout, bench.py's:
  {"metric": "vio_frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 40.0}
and on stderr the card's name and power limit, B, the frame count, lane
0's ATE and the worst lane's ATE.

Knobs are bench.py's environment variables, read the same way:
``BENCH_BATCH`` (16), ``BENCH_FRAMES`` (100), ``BENCH_REPS`` (3),
``BENCH_KLT_NORM``, ``BENCH_NOISE_ADAPTIVE``, ``BENCH_NS_ITERS`` (10) and
the rest of bench.py's; a value the port does not cover raises
``NotImplementedError`` from the configuration's ``check_supported``,
nothing falls back.  Runs on the CUDA card; ``main(device="cpu")`` runs on
the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Mapping, NamedTuple

import numpy as np
import torch

from .config import EUROC_CALIB, FilterConfig, FrontendConfig, resolve_device
from .io.tum import evaluate_ate
from .models import frontend as _frontend
from .models import msckf as _msckf
from .models.frontend import make_frontend_params
from .models.msckf import make_params
from .models.runner import pack_imu_batches
from .parallel.vio_multiseq import batched_gravity_init, batched_init_vio_state, run_vio_batch
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
    W, H = EUROC_CALIB.cam0.resolution
    _frontend.check_supported(fcfg, (H, W))
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

    def __call__(self):
        """(states, poses, fronts, metrics) of one run over the scene."""
        return run_vio_batch(
            self.states, self.imgs0, self.imgs1, self.times, self.imu, self.fparams, self.mparams,
            self.fcfg, self.mcfg, self.method, device=self.device,
        )


def prepare(scene: Scene, batch: int, fcfg, mcfg, method: str, device) -> BatchRun:
    """bench.py's set-up for ``batch`` lanes: filter and IMU in float32,
    gravity from the first 200 IMU samples."""
    dev = resolve_device(device)
    f32 = torch.float32
    T = scene.frame_idx.shape[0]
    states = batched_init_vio_state(fcfg, mcfg, EUROC_CALIB, scene.img0.shape[1:], batch, f32, f32, dev)
    states = batched_gravity_init(states, scene.imu.gyro[:200], scene.imu.acc[:200])
    batches = pack_imu_batches(
        scene.imu.t, scene.imu.gyro, scene.imu.acc, scene.frame_t, mcfg.max_imu_per_frame, np.float32,
        device=dev,
    )
    return BatchRun(
        states=states,
        imgs0=torch.as_tensor(scene.img0, dtype=f32).to(dev),
        imgs1=torch.as_tensor(scene.img1, dtype=f32).to(dev),
        times=torch.as_tensor(scene.frame_t, dtype=f32).to(dev).expand(batch, T),
        imu=map_tree(lambda x: x.expand(batch, *x.shape), batches),
        fparams=make_frontend_params(EUROC_CALIB, f32, dev),
        mparams=make_params(mcfg, EUROC_CALIB, f32, dev),
        fcfg=fcfg, mcfg=mcfg, method=method, device=dev,
    )


def lane_ates(scene: Scene, positions: np.ndarray) -> np.ndarray:
    """ATE RMSE of each lane's positions (B, T, 3) against the scene's
    ground truth."""
    t, gt = scene.frame_t, scene.traj.p[scene.frame_idx]
    return np.array([evaluate_ate(t, p, t, gt).rmse for p in positions])


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None) -> dict:
    """Run the benchmark; returns the printed JSON object."""
    env = os.environ
    fcfg, mcfg, method = bench_configs(env)
    dev = resolve_device(device)
    B = int(env.get("BENCH_BATCH", "16"))
    n_frames = int(env.get("BENCH_FRAMES", "100"))
    reps = int(env.get("BENCH_REPS", "3"))

    scene = bench_scene(n_frames)
    run = prepare(scene, B, fcfg, mcfg, method, dev)

    t0 = time.perf_counter()
    run()
    _sync(dev)
    warmup = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        _, poses, _, _ = run()
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps

    fps = round(B * n_frames / dt, 2)
    result = {
        "metric": "vio_frames_per_sec_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": round(fps / 40.0, 3),  # of the printed value, so the two always agree
    }
    print(json.dumps(result))
    ates = lane_ates(scene, poses.p.cpu().numpy())
    print(
        f"# device={card_description(dev)} frames={n_frames} batch={B} reps={reps} "
        f"warmup={warmup:.1f}s run={dt:.3f}s method={method} klt_norm={fcfg.klt_norm} "
        f"ate_rmse={ates[0]:.5f}m ate_rmse_worst_lane={ates.max():.5f}m",
        file=sys.stderr,
    )
    return result


if __name__ == "__main__":
    main()
