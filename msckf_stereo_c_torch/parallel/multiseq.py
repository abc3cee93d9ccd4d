"""B feature-track sequences through the filter, over the ranks of a
process group (port of ``msckf_stereo_c_tpu/parallel/multiseq.py``).

The JAX module batches sequences with ``vmap`` and splits the batch over a
``Mesh`` with ``shard_map``, with a ``psum`` only for the cross-sequence
metric.  Here the batch is the leading lane axis of one batched state,
stepped frame by frame through ``models/msckf.py:batched_filter_step``, and
the process group takes the mesh's place: each rank steps its contiguous
block of lanes (``collectives.process_lane_range``) on its own device, and
one ``all_reduce`` a chunk sums the metric.  ``make_mesh`` has no
counterpart: pass ``group`` (None: the default group when one is
initialised, else this one process).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import FilterConfig, StereoCalib, resolve_device
from ..models.msckf import FrameFeatures, MsckfParams, make_params
from ..models.runner import _run_chunk, batched_apply_gravity_init, pack_imu_batches
from ..models.state import FilterState, init_filter_state
from ..utils.lanes import map_tree, stack_lanes
from .collectives import all_reduce_sum, process_lane_range, resolve_group

__all__ = [
    "batched_gravity_init", "batched_init_state", "make_sharded_runner", "run_multi_sequence",
]


def batched_init_state(
    cfg: FilterConfig, calib: StereoCalib, batch: int, dtype=torch.float32, device=None
) -> FilterState:
    """``batch`` copies of the initial filter state on ``device``."""
    one = init_filter_state(cfg, calib, dtype, device)
    return map_tree(lambda x: x.expand(batch, *x.shape).clone(), one)


def batched_gravity_init(states: FilterState, gyro_windows, acc_windows) -> FilterState:
    """Per-lane gravity/bias init: windows have shape (B, n, 3)."""
    return batched_apply_gravity_init(states, gyro_windows, acc_windows)


def make_sharded_runner(params: MsckfParams, cfg: FilterConfig, method: str = "cholesky", group=None):
    """The multi-sequence chunk runner of this rank.

    The returned callable maps (states (B, ...), frames (B, T, ...), imu
    (B, T, L, ...)), this rank's lanes on its device, to (new_states,
    poses, metrics): the states after the last frame, PoseOutput (B, T, ...)
    and ``total_tracks`` summed over the group's ranks (one ``all_reduce``
    a chunk, none inside the frame loop).  ``real`` counts the leading
    lanes that are sequences; the rest pad the batch to the world size and
    are left out of the metric."""
    group, _, _ = resolve_group(group)

    def run(states: FilterState, frames: FrameFeatures, imu, real: int | None = None):
        new_states, poses = _run_chunk(states, frames, imu, params, cfg, method)
        (total,) = all_reduce_sum([torch.sum(poses.num_tracks[:real])], group)
        return new_states, poses, {"total_tracks": total}

    return run


def run_multi_sequence(
    cfg: FilterConfig,
    calib: StereoCalib,
    frame_t: np.ndarray,  # (B, T)
    fid: np.ndarray,  # (B, T, F)
    uv: np.ndarray,  # (B, T, F, 4)
    valid: np.ndarray,  # (B, T, F)
    imu_t: np.ndarray,  # (B, N)
    imu_gyro: np.ndarray,  # (B, N, 3)
    imu_acc: np.ndarray,  # (B, N, 3)
    dtype=torch.float32,
    method: str = "cholesky",
    device=None,
    group=None,
):
    """B feature-track sequences through the filter (the batched
    ``runner.run_sequence``) on ``device`` (the CUDA card when None).

    The batch is padded to a multiple of the world size by repeating the
    last lane, as JAX pads it to the mesh, and each rank builds and steps
    only its block of lanes.  Returns (states, poses, metrics): the
    states on the device and the poses as numpy (PoseOutput), of all B
    lanes in one process, or under a group of this rank's lanes
    ``[lo, min(hi, B))`` with ``(lo, hi) = process_lane_range(B + pad,
    world, rank)``; ``metrics['total_tracks']`` sums the B sequences over
    every rank.  (JAX's psum also counts its padding lanes, so its total
    depends on the mesh size.)"""
    device = resolve_device(device)
    group, world, rank = resolve_group(group)
    B = frame_t.shape[0]
    pad = (-B) % world
    lo, hi = process_lane_range(B + pad, world, rank)
    lanes = np.minimum(np.arange(lo, hi), B - 1)
    real = max(0, min(hi, B) - lo)

    params = make_params(cfg, calib, dtype, device)
    states = batched_init_state(cfg, calib, hi - lo, dtype, device)
    n0 = min(cfg.imu_init_samples, imu_t.shape[1])
    states = batched_gravity_init(states, imu_gyro[lanes, :n0], imu_acc[lanes, :n0])

    imu = stack_lanes([
        pack_imu_batches(imu_t[b], imu_gyro[b], imu_acc[b], frame_t[b], cfg.max_imu_per_frame, device=device)
        for b in lanes
    ])

    def dev(x, dt):
        return torch.as_tensor(np.asarray(x)[lanes], dtype=dt).to(device)

    frames = FrameFeatures(
        time=dev(np.asarray(frame_t, np.float64), dtype),
        fid=dev(fid, torch.int32),
        uv=dev(uv, dtype),
        valid=dev(valid, torch.bool),
    )
    run = make_sharded_runner(params, cfg, method=method, group=group)
    new_states, poses, metrics = run(states, frames, imu, real=real)
    return (
        map_tree(lambda x: x[:real], new_states),
        map_tree(lambda x: x[:real].cpu().numpy(), poses),
        {k: int(v) for k, v in metrics.items()},
    )
