"""Compile-check entry point of the port (counterpart of
``__graft_entry__.py:entry``).

``entry()`` returns ``(fn, example_args)``: one full-pipeline stereo VIO
step (both images and an IMU batch in, the new state and the pose out) at
EuRoC resolution, 752x480, in the flagship configuration of the JAX entry:
``FrontendConfig()``, ``FilterConfig()`` (exact solves, ``ns_iters=0``),
the filter in float32 and the ``'cholesky'`` update.  Runs on the CUDA card
unless ``device`` names another.  The multi-chip dry run
(``dryrun_multichip``) is not ported yet.
"""
from __future__ import annotations

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
