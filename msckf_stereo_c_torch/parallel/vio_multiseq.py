"""B independent VIO sequences stepped together on one card (port of
``msckf_stereo_c_tpu/parallel/vio_multiseq.py``, its one-card case).

The JAX module runs B sequences under ``jax.vmap`` and shards them over a
device mesh.  Here ``run_vio_batch`` steps the B lanes of one batched state
frame by frame through ``models.vio.batched_vio_step``: every kernel
launches once per frame for the features of all lanes.  Sharding the lanes
over several cards is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import FilterConfig, FrontendConfig, StereoCalib, resolve_device
from ..models import msckf as _msckf
from ..models.frontend import FrontendParams
from ..models.msckf import MsckfParams
from ..models.propagation import ImuBatch
from ..models.runner import batched_apply_gravity_init
from ..models.vio import VioState, _on_device, init_vio_state, stack_frames, step_frames
from ..utils.lanes import map_tree

__all__ = ["batched_gravity_init", "batched_init_vio_state", "broadcast_state", "run_vio_batch"]


def batched_init_vio_state(
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    calib: StereoCalib,
    img_shape: Tuple[int, int],
    batch: int,
    image_dtype=torch.float32,
    filter_dtype=torch.float32,
    device=None,
) -> VioState:
    """``batch`` copies of the initial state, on the CUDA card unless
    ``device`` names another."""
    return broadcast_state(init_vio_state(fcfg, mcfg, calib, img_shape, image_dtype, filter_dtype, device), batch)


def broadcast_state(state: VioState, batch: int) -> VioState:
    """``batch`` lanes that each hold a copy of one sequence's ``state``.
    The previous-frame pyramids stay one broadcast view: a frame step
    only reads them, as lanes that share one image do."""

    def copies(tree):
        return map_tree(lambda x: x.expand(batch, *x.shape).clone(), tree)

    return VioState(
        tracker=copies(state.tracker),
        filt=copies(state.filt),
        pyr0_prev=tuple(lvl.expand(batch, *lvl.shape) for lvl in state.pyr0_prev),
        prev_time=copies(state.prev_time),
    )


def batched_gravity_init(states: VioState, gyro_windows, acc_windows) -> VioState:
    """Per-lane gravity/bias init of the filter half; windows are
    (B, n, 3), or (n, 3) shared by every lane."""
    return states._replace(filt=batched_apply_gravity_init(states.filt, gyro_windows, acc_windows))


def run_vio_batch(
    states: VioState,
    imgs0,
    imgs1,
    times,
    imu: ImuBatch,
    fparams: FrontendParams,
    mparams: MsckfParams,
    fcfg: FrontendConfig,
    mcfg: FilterConfig,
    method: str = "schur",
    device=None,
):
    """Step B sequences over T frames on the CUDA card (or on ``device``).

    ``states`` is a batched state (B, ...), ``imgs0``/``imgs1`` are
    (B, T, H, W) per lane or (T, H, W) shared by every lane (host arrays or
    tensors), ``times`` (B, T) and ``imu`` a batch (B, T, L, ...).  Returns
    (states, poses, fronts, metrics): the states after the last frame,
    PoseOutput and FrameOutput trees (B, T, ...), and ``metrics`` with the
    cross-sequence ``total_tracks`` and ``max_online_reset_count`` of
    ``make_sharded_vio_runner``."""
    device = resolve_device(device)
    _msckf.check_supported(mcfg, method)
    idtype = states.tracker.pts0.dtype
    fdtype = states.filt.P.dtype
    states = map_tree(lambda x: x.to(device), states)
    imgs0 = _on_device(imgs0, idtype, device)
    imgs1 = _on_device(imgs1, idtype, device)
    times = _on_device(times, fdtype, device)
    imu = map_tree(lambda x: torch.as_tensor(x, device=device), imu)
    states, poses, fronts = step_frames(
        states, imgs0, imgs1, times, imu, fparams, mparams, fcfg, mcfg, method
    )
    poses, fronts = stack_frames(poses), stack_frames(fronts)
    metrics = {
        "total_tracks": torch.sum(poses.num_tracks),
        "max_online_reset_count": torch.max(states.filt.online_reset_count),
    }
    return states, poses, fronts, metrics
