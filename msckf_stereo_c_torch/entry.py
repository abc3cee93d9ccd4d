"""Compile-check entry point of the port (counterpart of
``__graft_entry__.py:entry``).

``entry()`` returns ``(fn, example_args)``: one full-pipeline stereo VIO
step (both images and an IMU batch in, the new state and the pose out) at
EuRoC resolution, 752x480, in the flagship configuration of the JAX entry:
``FrontendConfig()``, ``FilterConfig()`` (exact solves, ``ns_iters=0``),
the filter in float32 and the ``'cholesky'`` update.  Runs on the CUDA card
unless ``device`` names another.

``dryrun_multichip(n)`` (counterpart of ``__graft_entry__.py:
dryrun_multichip``) runs the flagship pipeline over n lanes through the
sharded runner, in one process and across OS processes.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .config import EUROC_CALIB, FilterConfig, FrontendConfig, resolve_device
from .models.frontend import make_frontend_params
from .models.msckf import make_params
from .models.propagation import ImuBatch
from .models.vio import init_vio_state, vio_step


def entry(device=None):
    device = resolve_device(device)
    fcfg = FrontendConfig()
    mcfg = FilterConfig()
    dtype = torch.float32
    fparams = make_frontend_params(EUROC_CALIB, torch.float32, device)
    mparams = make_params(mcfg, EUROC_CALIB, dtype, device)

    H, W = 480, 752
    state = init_vio_state(fcfg, mcfg, EUROC_CALIB, (H, W), torch.float32, dtype, device)
    rng = np.random.default_rng(0)
    img0 = torch.as_tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32).to(device)
    img1 = torch.as_tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32).to(device)
    t = torch.tensor(0.05, dtype=dtype, device=device)
    L = mcfg.max_imu_per_frame
    imu = ImuBatch(
        time=torch.linspace(0.0, 0.05, L, dtype=dtype, device=device),
        gyro=torch.zeros((L, 3), dtype=dtype, device=device),
        acc=torch.as_tensor(np.tile([0.0, 0.0, 9.81], (L, 1)), dtype=dtype).to(device),
        valid=torch.ones((L,), dtype=torch.bool, device=device),
    )

    def fn(state, img0, img1, t, imu):
        return vio_step(state, img0, img1, t, imu, fparams, mparams, fcfg, mcfg, "cholesky")

    return fn, (state, img0, img1, t, imu)


def _print_reports(reports) -> None:
    for r in reports:
        print(f"MULTIPROC_OK dryrun {json.dumps(r)}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The flagship full pipeline (rendered 752x480 stereo frames ->
    pyramids -> the hand LK and template kernels -> the Schur filter with
    Newton-Schulz solves, bench.py's configuration: M=20, K=128, float32)
    over ``n_devices`` distinct lanes of T = M+2 frames, so every lane's
    camera window fills and prunes, through ``make_sharded_vio_runner``,
    with JAX's asserts (finite poses, more than 10 tracks after RANSAC at
    the last frame, M-2 <= num_cams <= M).  On the CUDA card unless
    ``device`` names another.

    ``MSCKF_MULTIPROC=P`` (P >= 2) runs it instead across P OS processes,
    ``n_devices / P`` lanes each (``parallel/multiproc.py``: a
    ``torch.distributed`` group, per-process feeding, cross-process
    reductions).  Otherwise the one-process run comes first, and with
    ``MSCKF_MULTIPROC_AUTO`` on (the default, for n >= 2) the 2-process
    tier follows with one lane per process.  Each rank is held against a
    one-process run of its own lanes (ids and validity on the first 10
    frames, positions within ``multiproc.LANE_TOL_M``).

    Returns {"one_process": {...}, "multi_process": [rank reports]}, with
    the keys that ran: launch counts, frames, metrics, per-lane gaps."""
    from .parallel import multiproc

    out = {}
    nproc = int(os.environ.get("MSCKF_MULTIPROC", "0"))
    if nproc >= 2:
        if n_devices % nproc:
            raise ValueError(f"{n_devices} lanes do not divide over {nproc} processes")
        out["multi_process"] = multiproc.run_tier("dryrun", nproc, n_devices // nproc, device)
        _print_reports(out["multi_process"])
        print(f"dryrun_multichip OK: {n_devices} lanes across {nproc} OS processes "
              f"(torch.distributed, {out['multi_process'][0]['backend']}), full pipeline")
        return out

    device = resolve_device(device)
    res = multiproc.run_dryrun(range(n_devices), device)
    got, metrics, launches, T = res.outputs, res.metrics, res.launches, res.frames
    mcfg = FilterConfig(ns_iters=10)
    tracked = multiproc.check_dryrun(got, mcfg)
    out["one_process"] = dict(lanes=n_devices, frames=T, launches=launches, seconds=res.seconds,
                              num_cams=got["num_cams"].tolist(), min_after_ransac=tracked, **metrics)
    print(f"dryrun_multichip OK: {n_devices} lanes, full pipeline (752x480 frames, schur+NS, "
          f"M={mcfg.max_cam_state_size}, K={mcfg.max_tracks}), T={T} frames (cam window filled + pruned: "
          f"num_cams={got['num_cams'].tolist()}), poses {tuple(got['p'].shape)}, min after_ransac={tracked}, "
          f"total_tracks={metrics['total_tracks']}, launches {launches}")
    if os.environ.get("MSCKF_MULTIPROC_AUTO", "1") == "1" and n_devices >= 2:
        out["multi_process"] = multiproc.run_tier("dryrun", 2, 1, device)
        _print_reports(out["multi_process"])
        print(f"dryrun_multichip OK: multi-process tier, 2 lanes across 2 OS processes "
              f"(torch.distributed, {out['multi_process'][0]['backend']}), full pipeline")
    return out
