"""Multi-process execution tier over ``torch.distributed`` (port of
``msckf_stereo_c_tpu/parallel/multiproc.py``).

What one process can never exercise is the multi-process semantics: a
group built from separate OS processes, per-process data feeding, and
collectives that cross a process boundary.  This module adds that tier:

- ``init_distributed``: one process's bring-up as a rank of the group,
  over ``gloo`` on the CPU or when ranks share a card (NCCL refuses two
  ranks on one device), over ``nccl`` when every rank on its host has a
  card of its own; the backend is chosen by that rule from the ranks on
  this host (``LOCAL_WORLD_SIZE`` or ``--local-world-size``; the whole
  group when neither is given) and printed in the worker's line;
- per-process feeding and read-back: each rank builds only its block of
  lanes (``collectives.process_lane_range``; the BA worker its block of
  landmarks, with the poses replicated) on its own device, and reads back
  only its own tensors (``local_values``).  There is no global array to
  assemble;
- the deterministic problem builders, shared by the workers and the
  parent's one-process reference runs: lane b's inputs depend on b only;
- the workers (``vio``, ``ba``, ``dryrun``, ``bench``), each printing one
  ``MULTIPROC_OK`` line (``bench`` also a ``MULTIPROC_BENCH`` line) with
  its device, backend and kernel launch counts (the parent cannot read
  another process's counters), and ``launch_workers``, which spawns them.

In the JAX module a process owns several devices of a global mesh.  Here a
rank owns one device (``cuda:{local_rank % device_count}``, the local rank
from ``LOCAL_RANK`` or ``--local-rank``, else the rank; or the CPU), and its
"devices" (``--devices-per-process``) are its lanes of one batched step on
that device.  Launch a tier by hand (the launcher form of ``main``):

    python -m msckf_stereo_c_torch.parallel.multiproc --mode vio --num-processes 2 --device cpu

and without ``--device cpu`` on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import EUROC_CALIB, FilterConfig, FrontendConfig, StereoCalib, resolve_device
from ..ops import _cuda
from .collectives import process_lane_range, resolve_group

# Small but complete: the camera window fills and the prune runs (T >= M+2),
# at half EuRoC resolution so two worker processes run quickly on a host.
VIO_LANES = 4
VIO_FRAMES = 8  # = max_cam_state_size + 2
BA_ITERS = 8
LANE_TOL_M = 2e-4  # per-lane position bar against a one-process run (PERF.md §2)
ID_FRAMES = 10  # frames whose ids and validity must equal the one-process run's
TIMEOUT_S = 1500.0

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Runtime bring-up


def worker_device(device, rank: int, local_rank: int | None = None) -> torch.device:
    """A rank's device: the CPU when ``device`` names it, else
    ``cuda:{local_rank % device_count}`` (``local_rank``, the rank's index
    among the ranks on its host, is the rank itself when None: one host);
    raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the workers on the CPU")
    return torch.device("cuda", (rank if local_rank is None else local_rank) % torch.cuda.device_count())


def pick_backend(device: torch.device, num_processes: int, local_world_size: int | None = None) -> str:
    """``nccl`` when every rank on this host has a card of its own, else
    ``gloo`` (the CPU, or several ranks on one card, which NCCL refuses).
    ``local_world_size``, the count of ranks on this host, is the whole
    group's ``num_processes`` when None: one host."""
    local = num_processes if local_world_size is None else local_world_size
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator: str,
    num_processes: int,
    process_id: int,
    device=None,
    backend: str | None = None,
    timeout: float = TIMEOUT_S,
    local_rank: int | None = None,
    local_world_size: int | None = None,
):
    """Join THIS process to the group as rank ``process_id`` of
    ``num_processes`` at ``coordinator`` (``host:port``).  Returns (device,
    backend); the device follows ``local_rank`` and ``backend`` None is
    picked by ``pick_backend`` from ``local_world_size`` (both None on one
    host).  Every collective, the rendezvous included, gives up after
    ``timeout`` seconds, so a rank whose peer died does not wait for ever."""
    dev = worker_device(device, process_id, local_rank)
    backend = backend or pick_backend(dev, num_processes, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout),
    )
    return dev, backend


def local_values(tree: dict) -> dict:
    """numpy copies of this rank's tensors (its own lanes; replicated
    values once): the counterpart of JAX's read-back of addressable
    shards."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Deterministic problem builders (shared by the workers and the parent's
# reference runs: every process regenerates the same data for its lanes).


def _half_res_calib() -> StereoCalib:
    def half(cam):
        fx, fy, cx, cy = cam.intrinsics
        w, h = cam.resolution
        return dataclasses.replace(cam, intrinsics=(fx / 2, fy / 2, cx / 2, cy / 2), resolution=(w // 2, h // 2))

    return dataclasses.replace(EUROC_CALIB, cam0=half(EUROC_CALIB.cam0), cam1=half(EUROC_CALIB.cam1))


def vio_configs():
    fcfg = FrontendConfig(max_features=64)
    mcfg = FilterConfig(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
    return fcfg, mcfg, _half_res_calib()


def _render_lanes(renderer, traj, sim_imu, lanes, idx0: int, step: int, T: int, max_imu: int, device):
    """(imgs0, imgs1 (B, T, H, W), times (B, T) float32, imu (B, T, L))
    of the lanes ``lanes`` on ``device``: lane b's frames are the
    trajectory samples ``idx0 + step * b + 10 k``."""
    from ..models.runner import pack_imu_batches
    from ..sim.render_torch import StressEvents

    idx = np.stack([np.arange(idx0, idx0 + 10 * T, 10) + step * b for b in lanes])
    rendered = [renderer.render_sequence(traj, i, StressEvents.nominal(T)) for i in idx]
    imgs0 = torch.stack([r[0] for r in rendered])
    imgs1 = torch.stack([r[1] for r in rendered])
    times = torch.as_tensor(traj.t[idx].astype(np.float32), device=device)
    imu = pack_imu_batches(sim_imu.t, sim_imu.gyro, sim_imu.acc, traj.t[idx], max_imu, np.float32, device=device)
    return imgs0, imgs1, times, imu


def vio_lane_inputs(lanes: Sequence[int], T: int, mcfg: FilterConfig, calib: StereoCalib, device=None):
    """(imgs0, imgs1, times, imu) of the lanes ``lanes``, rendered on
    ``device`` (the CUDA card when None): lane b is its own sequence (the
    trajectory from sample 300 + 12 b), as in tests/test_vio_multiseq.py."""
    from ..sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from ..sim.render_torch import TorchRenderer

    device = resolve_device(device)
    traj = make_circle_trajectory(duration=6.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    sim_imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    renderer = TorchRenderer(np.asarray(lms), calib=calib, r_wall=8.0, device=device)
    return _render_lanes(renderer, traj, sim_imu, lanes, 300, 12, T, mcfg.max_imu_per_frame, device)


def _vio_outputs(new_states, poses, fronts) -> dict:
    return local_values({
        "p": poses.p, "q_xyzw": poses.q_xyzw, "num_tracks": poses.num_tracks, "fid": fronts.fid,
        "uv": fronts.uv, "valid": fronts.valid, "after_ransac": fronts.after_ransac,
        "num_cams": new_states.filt.num_cams,
    })


def _run_vio_block(lanes: Sequence[int], device, group=None):
    """The ``vio`` workers' run of the lanes ``lanes`` on ``device``, over
    ``group`` (None: alone).  Returns (outputs, metrics, launch counts)."""
    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from .vio_multiseq import batched_init_vio_state, make_sharded_vio_runner

    fcfg, mcfg, calib = vio_configs()
    f32 = torch.float32
    imgs0, imgs1, times, imu = vio_lane_inputs(lanes, VIO_FRAMES, mcfg, calib, device)
    states = batched_init_vio_state(fcfg, mcfg, calib, tuple(imgs0.shape[2:]), len(lanes), f32, f32, device)
    run = make_sharded_vio_runner(
        make_frontend_params(calib, f32, device), make_params(mcfg, calib, f32, device), fcfg, mcfg,
        method="schur", group=group,
    )
    _cuda.reset_launch_counts()
    new_states, poses, fronts, metrics = run(states, imgs0, imgs1, times, imu)
    _sync(torch.device(device))
    launches = dict(_cuda.launch_counts)
    return _vio_outputs(new_states, poses, fronts), {k: int(v) for k, v in metrics.items()}, launches


def _concat_blocks(blocks: Sequence[dict]) -> dict:
    """One reference from per-block runs, in lane order."""
    out = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    out["total_tracks"] = np.asarray(sum(int(b["num_tracks"].sum()) for b in blocks))
    return out


def run_vio_reference(world: int = 1, device=None) -> dict:
    """One-process runs of the ``vio`` workers' lane blocks for a group of
    ``world`` ranks (``world=1``: all VIO_LANES lanes in one batch), each
    block stepped on its own as its rank steps it, concatenated in lane
    order.  Float32 batched products round by batch shape, so a rank is
    held against the run of its own block.  Returns numpy arrays."""
    device = resolve_device(device)
    blocks = [
        _run_vio_block(range(*process_lane_range(VIO_LANES, world, r)), device)[0] for r in range(world)
    ]
    return _concat_blocks(blocks)


def ba_problem(device=None):
    """The deterministic synthetic BA problem of tests/test_ba.py (cameras
    on an arc observing a landmark cloud, perturbed) in float64 on
    ``device``."""
    from ..utils.lie import so3_exp
    from ..utils.quaternion import jpl_to_rot, rot_to_jpl
    from .ba import BAProblem

    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    rng = np.random.default_rng(31)
    F, L = 6, 64
    R01, t01 = t(np.eye(3)), t([-0.1, 0.0, 0.0])
    Rs, ps = [], []
    for i in range(F):
        a = 0.25 * i
        ps.append([2.0 * np.sin(a), 0.05 * i, -2.0 * np.cos(a)])
        c, s = np.cos(0.08 * i), np.sin(0.08 * i)
        Rs.append([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    cam_q, cam_p = rot_to_jpl(t(Rs)), t(ps)
    lms = t(rng.uniform(-1.0, 1.0, (L, 3)) + np.array([0, 0, 1.5]))
    R0 = jpl_to_rot(cam_q)
    p_c0 = torch.einsum("fij,lfj->lfi", R0, lms[:, None] - cam_p[None])
    p_c1 = torch.einsum("ij,lfj->lfi", R01, p_c0) + t01
    mask = (p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3)
    obs = torch.cat([p_c0[..., :2] / p_c0[..., 2:], p_c1[..., :2] / p_c1[..., 2:]], dim=-1) * mask[..., None]
    dth = rng.normal(0, 0.02, (F, 3))
    dth[0] = 0
    dp = rng.normal(0, 0.02, (F, 3))
    dp[0] = 0
    q_pert = rot_to_jpl(so3_exp(t(dth)) @ jpl_to_rot(cam_q))
    return BAProblem(q_pert, cam_p + t(dp), lms + t(rng.normal(0, 0.02, (L, 3))), obs, mask, R01, t01)


def run_ba_reference(device=None) -> dict:
    """The one-process BA solve of ``ba_problem`` (BA_ITERS steps)."""
    from .ba import ba_gauss_newton

    refined, costs = ba_gauss_newton(ba_problem(device), iters=BA_ITERS)
    return local_values({"cam_q": refined.cam_q, "cam_p": refined.cam_p, "landmarks": refined.landmarks,
                         "costs": costs})


class DryrunInputs(NamedTuple):
    """The flagship configuration's run of some lanes, on one device."""

    fcfg: FrontendConfig
    mcfg: FilterConfig
    fparams: object
    mparams: object
    states: object
    imgs0: torch.Tensor
    imgs1: torch.Tensor
    times: torch.Tensor
    imu: object


def dryrun_inputs(lanes: Sequence[int], device=None) -> DryrunInputs:
    """The bench configuration (``FrontendConfig()``, ``FilterConfig(
    ns_iters=10)``, float32, 752x480) over T = max_cam_state_size + 2
    frames, so the camera window fills and prunes, for the lanes ``lanes``:
    lane b is the trajectory from sample 320 + 10 b, rendered on
    ``device``; gravity from the first 200 IMU samples."""
    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from ..sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
    from ..sim.render_torch import TorchRenderer
    from .vio_multiseq import batched_gravity_init, batched_init_vio_state

    device = resolve_device(device)
    f32 = torch.float32
    fcfg = FrontendConfig()
    mcfg = FilterConfig(ns_iters=10)
    T = mcfg.max_cam_state_size + 2
    traj = make_circle_trajectory(duration=8.0)
    lms = make_wall_landmarks(num=400, radius=8.0, seed=1)
    sim_imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    renderer = TorchRenderer(np.asarray(lms), r_wall=8.0, device=device)
    imgs0, imgs1, times, imu = _render_lanes(renderer, traj, sim_imu, lanes, 320, 10, T, mcfg.max_imu_per_frame,
                                             device)
    states = batched_init_vio_state(fcfg, mcfg, EUROC_CALIB, tuple(imgs0.shape[2:]), len(lanes), f32, f32, device)
    states = batched_gravity_init(states, sim_imu.gyro[:200], sim_imu.acc[:200])
    return DryrunInputs(fcfg, mcfg, make_frontend_params(EUROC_CALIB, f32, device),
                        make_params(mcfg, EUROC_CALIB, f32, device), states, imgs0, imgs1, times, imu)


class DryrunRun(NamedTuple):
    outputs: dict  # numpy per lane (``_vio_outputs``)
    metrics: dict  # the runner's reduced metrics, as integers
    launches: dict  # kernel launches of the first run
    frames: int
    seconds: float  # wall time of the first run, the device synchronised
    step_ms: float | None  # mean ms of ``time_reps`` more runs (None: none)


def run_dryrun(lanes: Sequence[int], device=None, group=None, time_reps: int = 0) -> DryrunRun:
    """One run of the flagship chunk over ``lanes`` (over ``group``), launch
    counts zeroed just before and read just after; then ``time_reps`` more
    runs timed."""
    from .vio_multiseq import make_sharded_vio_runner

    inp = dryrun_inputs(lanes, device)
    runner = make_sharded_vio_runner(inp.fparams, inp.mparams, inp.fcfg, inp.mcfg, method="schur", group=group)

    def run():
        return runner(inp.states, inp.imgs0, inp.imgs1, inp.times, inp.imu)

    dev = inp.imgs0.device
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    new_states, poses, fronts, metrics = run()
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(_cuda.launch_counts)
    step_ms = None
    if time_reps:
        t1 = time.perf_counter()
        for _ in range(time_reps):
            run()
        _sync(dev)
        step_ms = (time.perf_counter() - t1) * 1e3 / time_reps
    return DryrunRun(_vio_outputs(new_states, poses, fronts), {k: int(v) for k, v in metrics.items()}, launches,
                     int(inp.times.shape[1]), secs, step_ms)


def check_dryrun(got: dict, mcfg: FilterConfig) -> int:
    """JAX's dry-run asserts: finite poses, more than 10 tracks after
    RANSAC at the last frame, the camera window filled and pruned.
    Returns the least track count at the last frame."""
    if not np.all(np.isfinite(got["p"])):
        raise RuntimeError("dryrun: non-finite poses")
    tracked = int(got["after_ransac"][:, -1].min())
    if tracked <= 10:
        raise RuntimeError(f"dryrun: the front end lost tracking ({tracked} tracks after RANSAC)")
    M = mcfg.max_cam_state_size
    if not (int(got["num_cams"].max()) <= M and int(got["num_cams"].min()) >= M - 2):
        raise RuntimeError(f"dryrun: the camera window did not fill and prune: num_cams {got['num_cams']}")
    return tracked


def run_dryrun_reference(world: int, lanes_per_rank: int, device=None) -> dict:
    """One-process runs of the ``dryrun`` workers' lane blocks, each on
    its own, concatenated in lane order (numpy)."""
    device = resolve_device(device)
    B = world * lanes_per_rank
    return _concat_blocks([run_dryrun(range(*process_lane_range(B, world, r)), device).outputs
                           for r in range(world)])


def lane_gaps(got: dict, ref: dict, n_frames: int = ID_FRAMES) -> dict:
    """A rank's lanes against the same lanes of a one-process run: whether
    ids and validity equal over the first ``n_frames`` frames, and the
    largest position gap over every frame (metres)."""
    k = slice(0, n_frames)
    return {
        "ids_equal": bool(np.array_equal(got["fid"][:, k], ref["fid"][:, k])
                          and np.array_equal(got["valid"][:, k], ref["valid"][:, k])),
        "max_position_gap_m": float(np.max(np.abs(got["p"] - ref["p"]))),
    }


# ---------------------------------------------------------------------------
# Worker modes


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _report(tag: str, mode: str, **fields) -> None:
    """One result line: ``<tag> <mode> {json}``."""
    print(f"{tag} {mode} {json.dumps(fields)}", flush=True)


def parse_reports(out: str, tag: str = "MULTIPROC_OK") -> list:
    """The JSON fields of every ``<tag>`` line of a worker's output."""
    reports = []
    for line in out.splitlines():
        if line.startswith(tag + " "):
            mode, fields = line[len(tag) + 1:].split(" ", 1)
            reports.append(dict(json.loads(fields), mode=mode))
    return reports


def _load_ref(path: str) -> dict:
    with np.load(path) as f:
        return dict(f)


def _rank_fields(device, backend, lo, hi) -> dict:
    return dict(process=dist.get_rank(), world=dist.get_world_size(), backend=backend, device=str(device),
                lanes=[lo, hi])


def _worker_vio(args, device, backend) -> None:
    _, mcfg, _ = vio_configs()
    group, world, rank = resolve_group(None)
    lo, hi = process_lane_range(VIO_LANES, world, rank)
    got, metrics, launches = _run_vio_block(range(lo, hi), device, group)
    _require(bool(np.all(np.isfinite(got["p"]))), "vio: non-finite poses")
    _require(int(got["after_ransac"].min()) > 10, "vio: the front end lost tracking")
    _require(int(got["num_cams"].min()) >= mcfg.max_cam_state_size - 2, "vio: the camera window did not fill")
    local_total = int(got["num_tracks"].sum())
    gaps = None
    if args.ref:
        ref = _load_ref(args.ref)
        if device.type == "cpu":
            # Bit-level equality with the one-process run of this block:
            # lane math never crosses a process, and the CPU's arithmetic
            # is the same in every process with the same thread count.
            for key in ("p", "q_xyzw", "fid", "uv", "valid", "after_ransac", "num_cams"):
                np.testing.assert_array_equal(got[key], ref[key][lo:hi], err_msg=f"lane-sharded output {key!r}")
        gaps = lane_gaps(got, {k: ref[k][lo:hi] for k in ("fid", "valid", "p")})
        _require(gaps["ids_equal"] and gaps["max_position_gap_m"] <= LANE_TOL_M,
                 f"vio: lanes [{lo},{hi}) differ from the one-process run of the block: {gaps}")
        # The cross-process sum (an integer total) is exact.
        _require(metrics["total_tracks"] == int(ref["total_tracks"]),
                 f"vio: total_tracks {metrics['total_tracks']} != {int(ref['total_tracks'])}")
    _report("MULTIPROC_OK", "vio", **_rank_fields(device, backend, lo, hi), frames=VIO_FRAMES,
            total_tracks=metrics["total_tracks"], local_total_tracks=local_total,
            max_online_reset_count=metrics["max_online_reset_count"], launches=launches, gaps=gaps)


def _worker_ba(args, device, backend) -> None:
    from .ba import make_distributed_ba

    group, world, rank = resolve_group(None)
    prob = ba_problem(device)
    # Each rank takes exactly L / world landmarks (JAX's assert that the
    # per-process feed covers the sharded shape).
    lo, hi = process_lane_range(prob.landmarks.shape[0], world, rank)
    local = prob._replace(landmarks=prob.landmarks[lo:hi], obs=prob.obs[lo:hi], mask=prob.mask[lo:hi])
    refined, costs = make_distributed_ba(group, iters=BA_ITERS)(local)
    got = local_values({"cam_q": refined.cam_q, "cam_p": refined.cam_p, "landmarks": refined.landmarks,
                        "costs": costs})
    _require(got["costs"][-1] < 1e-3 * got["costs"][0], f"ba: costs did not fall: {got['costs']}")
    gaps = None
    if args.ref:
        ref = _load_ref(args.ref)
        gaps = {
            "poses": float(max(np.abs(got["cam_q"] - ref["cam_q"]).max(), np.abs(got["cam_p"] - ref["cam_p"]).max())),
            "landmarks_m": float(np.abs(got["landmarks"] - ref["landmarks"][lo:hi]).max()),
            "costs_rel": float(np.max(np.abs(got["costs"] - ref["costs"]) / np.maximum(np.abs(ref["costs"]), 1e-12))),
        }
        # The pose system is summed across processes in another order than
        # the one-process solve's: equal to machine precision, not bitwise.
        np.testing.assert_allclose(got["cam_q"], ref["cam_q"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["cam_p"], ref["cam_p"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["landmarks"], ref["landmarks"][lo:hi], rtol=0, atol=1e-9)
        # Converged costs reach ~1e-28, where a relative bar means nothing.
        np.testing.assert_allclose(got["costs"], ref["costs"], rtol=1e-6, atol=1e-18)
    _report("MULTIPROC_OK", "ba", **_rank_fields(device, backend, lo, hi),
            costs=[float(got["costs"][0]), float(got["costs"][-1])], gaps=gaps, launches=dict(_cuda.launch_counts))


def _worker_dryrun(args, device, backend, time_reps: int = 0) -> None:
    """The flagship pipeline (bench configuration, 752x480) across the
    processes, ``--devices-per-process`` lanes each: the multi-process
    form of ``entry.dryrun_multichip``.  With ``time_reps`` it also times
    that many more runs of the chunk (``bench``)."""
    group, world, rank = resolve_group(None)
    B = world * args.devices_per_process
    lo, hi = process_lane_range(B, world, rank)
    res = run_dryrun(range(lo, hi), device, group, time_reps)
    if time_reps:
        _report("MULTIPROC_BENCH", "bench", process=rank, world=world, device=str(device), backend=backend,
                step_ms=res.step_ms, lanes=hi - lo, frames=res.frames, reps=time_reps)
    got = res.outputs
    tracked = check_dryrun(got, FilterConfig(ns_iters=10))
    gaps = None
    if args.ref:
        ref = _load_ref(args.ref)
        gaps = lane_gaps(got, {k: ref[k][lo:hi] for k in ("fid", "valid", "p")})
        _require(gaps["ids_equal"] and gaps["max_position_gap_m"] <= LANE_TOL_M,
                 f"dryrun: lanes [{lo},{hi}) differ from the one-process run of the block: {gaps}")
    _report("MULTIPROC_OK", "dryrun", **_rank_fields(device, backend, lo, hi), of=B, frames=res.frames,
            num_cams=got["num_cams"].tolist(), min_after_ransac=tracked, local_total_tracks=int(got["num_tracks"].sum()),
            **res.metrics, launches=res.launches, gaps=gaps)


def _worker_bench(args, device, backend) -> None:
    """Timed flagship point across processes (``scripts/bench_scaling.py
    --processes`` reads the ``MULTIPROC_BENCH`` line): the wall time of one
    chunk, 1 lane per rank by default.  Ranks that share one card share
    its time, so on one card this is no multi-card scaling number."""
    _worker_dryrun(args, device, backend, time_reps=int(os.environ.get("MSCKF_BENCH_REPS", "2")))


_WORKERS = {"vio": _worker_vio, "ba": _worker_ba, "dryrun": _worker_dryrun, "bench": _worker_bench}


# ---------------------------------------------------------------------------
# Launcher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_workers(
    mode: str,
    num_processes: int = 2,
    devices_per_process: int = 1,
    ref_path: str | None = None,
    timeout: float = TIMEOUT_S,
    device=None,
):
    """Spawn ``num_processes`` worker processes of ``mode`` and wait.
    Returns [(returncode, output), ...] in rank order, and checks none of
    them: the caller does.

    The workers join over ``localhost``, run ``python -m
    msckf_stereo_c_torch.parallel.multiproc`` with ``PYTHONPATH`` at the
    root of the checkout and no JAX variables in their environment, on the
    card unless ``device`` names the CPU, with the caller's count of CPU
    threads (so a one-process reference run in the caller rounds as the
    workers do), each told its local rank and the local world size (all
    ranks run on this host).  When one rank fails, the others are killed; after
    ``timeout`` seconds every rank still running is killed."""
    dev = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if dev == "cuda":
        resolve_device(None)  # raises without a card
        _cuda.build_kernels()  # once here, so the ranks load the libraries
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            cmd = [
                sys.executable, "-m", "msckf_stereo_c_torch.parallel.multiproc",
                "--mode", mode, "--process-id", str(pid), "--num-processes", str(num_processes),
                "--coordinator", f"localhost:{port}", "--devices-per-process", str(devices_per_process),
                "--device", dev, "--threads", str(torch.get_num_threads()), "--timeout", str(timeout),
                "--local-rank", str(pid), "--local-world-size", str(num_processes),
            ]
            if ref_path:
                cmd += ["--ref", ref_path]
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True, env=env,
                                          cwd=_ROOT))
        notes = [""] * num_processes
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = f"rank {failed[0]} failed" if failed else "timeout"
                for i, p in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        notes[i] = f"\n<KILLED: {why}>" if failed else "\n<TIMEOUT>"
                break
            time.sleep(0.1)
        results = []
        for p, log, note in zip(procs, logs, notes):
            p.wait()
            log.seek(0)
            results.append((p.returncode, log.read() + note))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def check_workers(results, tag: str = "MULTIPROC_OK") -> list:
    """Every rank's parsed ``tag`` lines, in rank order; raises if a rank
    exited with a code other than 0 or printed no ``MULTIPROC_OK`` line."""
    for i, (rc, out) in enumerate(results):
        if rc != 0 or not parse_reports(out):
            raise RuntimeError(f"multi-process worker {i} failed (rc={rc}):\n{out[-4000:]}")
    return [parse_reports(out, tag) for _, out in results]


def run_tier(mode: str, num_processes: int, devices_per_process: int = 1, device=None,
             timeout: float = TIMEOUT_S, tag: str = "MULTIPROC_OK") -> list:
    """One worker tier, held to its one-process reference: the ``vio``,
    ``ba`` and ``dryrun`` workers get the one-process runs of their blocks
    (computed here, on ``device``), ``bench`` none.  Returns the ranks'
    ``tag`` reports; raises if a rank failed."""
    ref = None
    if mode == "vio":
        ref = run_vio_reference(num_processes, device)
    elif mode == "ba":
        ref = run_ba_reference(device)
    elif mode == "dryrun":
        ref = run_dryrun_reference(num_processes, devices_per_process, device)
    with tempfile.TemporaryDirectory() as tmp:
        path = None
        if ref is not None:
            path = os.path.join(tmp, f"{mode}_ref.npz")
            np.savez(path, **ref)
        results = launch_workers(mode, num_processes, devices_per_process, path, timeout, device)
    return [r[0] for r in check_workers(results, tag)]


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    return None if raw is None else int(raw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=tuple(_WORKERS), required=True)
    ap.add_argument("--process-id", type=int, default=None,
                    help="this worker's rank; without it, launch --num-processes workers and report")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None, help="host:port of the rendezvous (workers)")
    ap.add_argument("--devices-per-process", type=int, default=1, help="lanes per rank (dryrun, bench)")
    ap.add_argument("--ref", default=None, help="reference npz to compare against (workers)")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; the card otherwise")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads of each worker")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S, help="seconds before the ranks give up")
    ap.add_argument("--local-rank", type=int, default=_env_int("LOCAL_RANK"),
                    help="this worker's index among the ranks on its host (default $LOCAL_RANK, else the rank)")
    ap.add_argument("--local-world-size", type=int, default=_env_int("LOCAL_WORLD_SIZE"),
                    help="ranks on this host (default $LOCAL_WORLD_SIZE, else --num-processes)")
    args = ap.parse_args(argv)

    if args.threads:
        torch.set_num_threads(args.threads)
    if args.process_id is None:
        tag = "MULTIPROC_BENCH" if args.mode == "bench" else "MULTIPROC_OK"
        reports = run_tier(args.mode, args.num_processes, args.devices_per_process, args.device,
                           args.timeout, tag)
        for r in reports:
            print(f"{tag} {r.pop('mode')} {json.dumps(r)}")
        return 0
    device, backend = init_distributed(args.coordinator, args.num_processes, args.process_id, args.device,
                                       timeout=args.timeout, local_rank=args.local_rank,
                                       local_world_size=args.local_world_size)
    try:
        _WORKERS[args.mode](args, device, backend)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
