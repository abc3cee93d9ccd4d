"""Fast-motion ATE at each matmul precision, front end and filter apart
(port of ``scripts/fastmotion_tpu_precision.py``).

    python -m msckf_stereo_c_torch.scripts.fastmotion_precision [filter[/frontend] ...]

Runs tests/test_fast_motion.py's scene (6 s circle, omega 2 pi / 8, roll
0.25, 500 wall landmarks, one stereo frame every 10 IMU samples) through
``run_vio_sequence`` with the JAX script's configuration (``max_features``
64; ``max_cam_state_size`` 8, ``max_tracks`` 80, ``max_imu_per_frame`` 12,
``ns_iters`` 10, float32 Schur filter, chunks of 40 frames) and prints, per
spec, the JAX script's line: the ATE RMSE and the fewest tracks over the
last 20 frames.

Each argument is ``<filter precision>`` or ``<filter>/<frontend>``; the
front end's defaults to ``'default'`` and the arguments to ``float32
tensorfloat32``, as in the JAX script.  The names are the port's
(``config.matmul_precision_scope``): only ``'default'`` lets the card use
TF32, and ``'bfloat16'`` / ``'bfloat16_3x'`` are one and three bf16 passes
per float32 product, the TPU's meaning (``ops/precision.py``); every spec
is checked before any frame runs.  Runs on the CUDA card; ``FM_PLATFORM=cpu`` selects
the CPU.  The scene is rendered by ``sim/render_torch.py`` on the run's
device.
"""
from __future__ import annotations

import os
import sys
from typing import Mapping, Sequence

import numpy as np
import torch

from ..bench import Scene
from ..config import EUROC_CALIB, FilterConfig, FrontendConfig, resolve_device
from ..io.tum import evaluate_ate
from ..models import msckf as _msckf
from ..models.vio import run_vio_sequence

DEFAULT_SPECS = ("float32", "tensorfloat32")


def fastmotion_scene(duration: float = 6.0, device=None) -> Scene:
    """tests/test_fast_motion.py's scene over ``duration`` seconds, its
    images rendered on ``device`` (the card when None)."""
    from ..sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from ..sim.render_torch import TorchRenderer

    traj = make_circle_trajectory(
        duration=duration, omega=2.0 * np.pi / 8.0, roll_amp=0.25, t_static=1.5, t_ramp=1.0
    )
    landmarks = make_wall_landmarks(num=500, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    frame_idx = np.arange(0, traj.t.shape[0], 10)
    img0, img1 = TorchRenderer(landmarks, r_wall=8.0, device=resolve_device(device)).render_sequence(traj, frame_idx)
    return Scene(traj, imu, frame_idx, img0, img1, landmarks)


def spec_configs(spec: str):
    """(FrontendConfig, FilterConfig) of one ``filter[/frontend]`` spec;
    raises ``ValueError`` for an unknown name."""
    filt_prec, _, front_prec = spec.partition("/")
    front_prec = front_prec or "default"
    fcfg = FrontendConfig(max_features=64, matmul_precision=front_prec)
    mcfg = FilterConfig(
        max_cam_state_size=8, max_tracks=80, max_imu_per_frame=12, ns_iters=10, matmul_precision=filt_prec
    )
    _msckf.check_supported(mcfg, "schur")
    return fcfg, mcfg


def run_spec(spec: str, scene: Scene, device=None) -> dict:
    """One spec over ``scene``: prints the JAX script's line and returns
    its numbers."""
    fcfg, mcfg = spec_configs(spec)
    res = run_vio_sequence(
        fcfg, mcfg, EUROC_CALIB, scene.frame_t, scene.img0, scene.img1,
        scene.imu.t, scene.imu.gyro, scene.imu.acc,
        filter_dtype=torch.float32, method="schur", chunk=40, device=device,
    )
    ate = evaluate_ate(res.times, res.positions, scene.frame_t, scene.traj.p[scene.frame_idx])
    tracks = int(res.tracking["after_ransac"][-20:].min())
    print(
        f"filter={mcfg.matmul_precision:15s} frontend={fcfg.matmul_precision:15s} "
        f"ate_rmse={ate.rmse:.4f}m min_tracks_last20={tracks}",
        flush=True,
    )
    return dict(filter=mcfg.matmul_precision, frontend=fcfg.matmul_precision, ate_rmse=float(ate.rmse),
                min_tracks_last20=tracks)


def main(argv: Sequence[str] | None = None, env: Mapping[str, str] = os.environ) -> dict:
    """Every spec of ``argv`` (the JAX defaults when empty) over the 6 s
    scene; returns {spec: numbers}."""
    specs = list(argv if argv is not None else sys.argv[1:]) or list(DEFAULT_SPECS)
    for spec in specs:
        spec_configs(spec)  # every name checked before the first frame
    device = resolve_device("cpu" if env.get("FM_PLATFORM") == "cpu" else None)
    scene = fastmotion_scene(device=device)
    return {spec: run_spec(spec, scene, device) for spec in specs}


if __name__ == "__main__":
    main()
