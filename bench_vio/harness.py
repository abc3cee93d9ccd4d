"""One run of one cell: set-up, the measured window, and the records the
metric readers and the judge read.

The window drives ``msckf_stereo_c_torch.models.vio.batched_vio_step``
frame by frame.  Set-up (not timed) renders the cell's scenes on the
device and keeps every frame resident, packs each lane's IMU with the
port's ``pack_imu_batches``, initialises the lanes with the port's
``batched_init_vio_state`` and ``batched_gravity_init``, and steps the
warm-up frames.  In the window each batched frame is handed in (a gather
of each lane's image from the resident scenes, the harness's only device
work) and stepped; a lane's pose is read to the host every frame
(``pose_read`` "frame", with the time from the frame handed in to its pose
on the host) or at each sequence's end ("sequence").  When a sequence
ends, every lane is initialised again, in the window, as a user's next
sequence, and the loop goes on.  The window ends at the first frame
boundary ``seconds`` after it opened, with the card synchronised.

At frames the seed draws (and always the first), the state of every lane
before the step (but its pyramids, which the judge works out again) and
the step's outputs are copied to the host for the judge (``judge.py``).
The card is synchronised before each copy, and the copies' time is left
out of the window: its seconds, and the end it is held to, count the
frames' work alone."""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent


def load_json(kind: str, name: str) -> dict:
    """``bench_vio/<kind>/<name>.json``."""
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of (named) tuples."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [tree_map(fn, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def alloc_bytes(t: torch.Tensor) -> int:
    """Bytes the caching allocator counts for ``t``'s own block (sizes
    round up to 512 bytes)."""
    n = t.untyped_storage().nbytes()
    return -(-n // 512) * 512


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_configs(config: dict, overrides: Optional[dict] = None):
    """(calib, FrontendConfig, FilterConfig, method) of the port, through
    its own loaders; ``overrides`` replaces fields (the judge's control)."""
    from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig, load_camchain, load_filter_config

    overrides = overrides or {}
    calib = load_camchain(str(REPO / config["calib"]["camchain"]))
    fcfg = FrontendConfig(**{**config["frontend"], **overrides.get("frontend", {})},
                          distortion_model0=calib.cam0.distortion_model,
                          distortion_model1=calib.cam1.distortion_model)
    mcfg = load_filter_config(str(REPO / config["calib"]["filter"]),
                              FilterConfig(**{**config["filter"], **overrides.get("filter", {})}))
    return calib, fcfg, mcfg, config["method"]


@dataclasses.dataclass
class Window:
    seconds: float  # from the window's opening to the synchronise after its last frame, the judge's copies left out
    frames: int  # batched frames stepped in the window
    lanes: int
    frame_ms: Optional[List[float]]  # per frame, handed in -> pose on the host; None without per-frame reads
    peak_bytes: Optional[int]  # torch.cuda.max_memory_allocated() over the window (None off the card)
    resident_bytes: int  # the harness's resident scenes, IMU and frame clock
    sequences: int  # sequences that ended in the window


@dataclasses.dataclass
class Trace:
    events: list  # trace.events.Event
    launches: list  # stage_ranges' hand-kernel launch log
    frames: int  # batched frames profiled
    syncs: Optional[int]  # synchronisations inside the port over those frames
    sync_sites: dict
    roofline: dict  # kernel -> [roofline.capture.Count]
    roofline_pairs: dict = dataclasses.field(default_factory=dict)  # kernel -> (logged launches, device events)

    @functools.cached_property
    def stage_table(self) -> dict:
        from .trace.stages import stage_table

        return stage_table(self.events, self.frames, self.launches)

    @functools.cached_property
    def span(self):
        from .trace.events import window

        return window(self.events)


@dataclasses.dataclass
class Check:
    k: int  # the frame's index in its sequence
    before: tuple  # the VioState before the step, without its pyramids (host)
    pose: tuple  # the step's PoseOutput
    out: tuple  # its FrameOutput
    P: torch.Tensor  # the covariance after the step


@dataclasses.dataclass
class Run:
    setup_s: float
    window: Window
    trace: Optional[Trace]
    attempted: int
    failed: int
    ates: np.ndarray  # (sequences run, B) ATE RMSE of each lane over each sequence's frames
    checks: List[Check]
    init: tuple  # the state after set-up's initialisation, without its pyramids (host)
    inputs: object  # scene.generate.CellInputs
    device: torch.device
    kind: str  # the card's name


def run_cell(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             overrides: Optional[dict] = None) -> Run:
    """Set up the cell from ``seed``, measure ``seconds`` of it (with
    ``trace``, its first ``trace_frames`` frames under the profiler) and
    return the run's records.  ``t0`` is the process's start on the
    ``time.perf_counter`` clock."""
    from msckf_stereo_c_torch.models import vio as _vio
    from msckf_stereo_c_torch.models.frontend import make_frontend_params
    from msckf_stereo_c_torch.models.msckf import make_params
    from msckf_stereo_c_torch.models.runner import pack_imu_batches
    from msckf_stereo_c_torch.parallel.vio_multiseq import batched_gravity_init, batched_init_vio_state

    from .reference.config import load_camchain as ref_camchain
    from .scene.generate import make_cell_inputs

    device = torch.device(device)
    f32 = torch.float32
    calib, fcfg, mcfg, method = program_configs(config, overrides)
    inputs = make_cell_inputs(config, cell, seed, ref_camchain(str(REPO / config["calib"]["camchain"])), device)
    B, T = int(cell["lanes"]), int(cell["seq_frames"])
    H, W = inputs.img0.shape[-2:]
    warmup = int(cell["warmup_frames"])
    if not 0 < warmup < T:
        raise ValueError(f"warm-up {warmup} must lie inside a sequence of {T} frames")
    per_frame = cell["pose_read"] == "frame"

    packed = [pack_imu_batches(inputs.imu_t, inputs.gyro[b], inputs.acc[b], inputs.frame_t, mcfg.max_imu_per_frame,
                               np.float32) for b in range(B)]
    imu_all = type(packed[0])(*(torch.stack(x).to(device) for x in zip(*packed)))  # (B, T, L, ...)
    del packed
    n0 = mcfg.imu_init_samples
    gyro0, acc0 = inputs.gyro[:, :n0], inputs.acc[:, :n0]
    times = torch.as_tensor(inputs.frame_t, dtype=f32, device=device)[:, None].expand(T, B).contiguous()
    lane_field = torch.as_tensor(inputs.lane_field, device=device)
    resident = sum(alloc_bytes(t) for t in (inputs.img0, inputs.img1, times, lane_field, *imu_all))
    fparams = make_frontend_params(calib, f32, device)
    mparams = make_params(mcfg, calib, f32, device)

    rng = np.random.default_rng([int(seed), 0xBE7C])

    def to_host(tree):
        return tree_map(lambda x: x.cpu(), tree)

    def state_to_host(state):
        return to_host(state._replace(pyr0_prev=()))

    def init_states():
        s = batched_init_vio_state(fcfg, mcfg, calib, (H, W), B, f32, f32, device)
        return batched_gravity_init(s, gyro0, acc0)

    def frame_images(k):
        if B == 1:  # one lane reads its frame as an (H, W) image, as a one-sequence run does
            return inputs.img0[0, k], inputs.img1[0, k]
        return inputs.img0[:, k].index_select(0, lane_field), inputs.img1[:, k].index_select(0, lane_field)

    st = dict(state=init_states(), k=0, frames=0, sequences=0, paused=0.0)
    init = state_to_host(st["state"])
    poses_dev: list = []  # (p, q) device tensors of the current sequence, read at its end
    poses_host: list = []  # (p, q) numpy per frame of the current sequence
    segments: list = []  # per sequence run: (frames, positions (n, B, 3), quaternions (n, B, 4))
    frame_ms: list = []
    checks: list = []
    counting = dict(on=False)

    def read_poses():
        if poses_dev:
            poses_host.extend((p.cpu().numpy(), q.cpu().numpy()) for p, q in poses_dev)
            poses_dev.clear()

    def close_sequence():
        read_poses()
        if poses_host:
            segments.append((len(poses_host), np.stack([p for p, _ in poses_host]),
                             np.stack([q for _, q in poses_host])))
        poses_host.clear()

    def paused(copy):
        """``copy()`` with the card drained first, its time kept out of the window."""
        _sync(device)
        p0 = time.perf_counter()
        out = copy()
        st["paused"] += time.perf_counter() - p0
        return out

    def do_frame(check: bool) -> None:
        k = st["k"]
        before = paused(lambda: state_to_host(st["state"])) if check else None
        t_in = time.perf_counter()
        i0, i1 = frame_images(k)
        imu = tree_map(lambda x: x[:, k], imu_all)
        st["state"], (pose, out) = _vio.batched_vio_step(
            st["state"], i0, i1, times[k], imu, fparams, mparams, fcfg, mcfg, method)
        if per_frame:
            poses_host.append((pose.p.cpu().numpy(), pose.q_xyzw.cpu().numpy()))
            frame_ms.append((time.perf_counter() - t_in) * 1e3)
        else:
            poses_dev.append((pose.p, pose.q_xyzw))
        if check:
            checks.append(paused(lambda: Check(k, before, to_host(pose), to_host(out), st["state"].filt.P.cpu())))
        st["k"] += 1
        if counting["on"]:
            st["frames"] += 1
        if st["k"] == T:
            close_sequence()
            st["state"] = None
            st["state"] = init_states()
            st["k"] = 0
            if counting["on"]:
                st["sequences"] += 1

    for _ in range(warmup):
        do_frame(False)
    read_poses()
    frame_ms.clear()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    every = float(cell["check_every"])
    traced = None
    counting["on"] = True
    st["paused"] = 0.0
    w0 = time.perf_counter()
    if trace:
        traced, cap = _traced_frames(int(cell["trace_frames"]), int(cell["roofline_frames"]), do_frame, device)
    while True:  # at least one frame, and the first one outside the profiler is checked
        do_frame(not checks or rng.random() < 1.0 / every)
        if time.perf_counter() - w0 - st["paused"] >= seconds:
            break
    _sync(device)
    w1 = time.perf_counter() - st["paused"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    close_sequence()

    if trace:
        from .roofline.capture import replay

        traced.roofline, traced.roofline_pairs = replay(cap, traced.events)
        del cap
    st["state"] = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ATE of each lane over each sequence run (warm-up frames included, as
    # a user's sequence includes them); counted lane-frames are the window's.
    from .reference.io.tum import evaluate_ate

    ates = []
    for n, pos, _ in segments:
        if n < 3:  # too short to align to the ground truth
            continue
        t = inputs.frame_t[:n]
        ates.append([evaluate_ate(t, pos[:, b], t, inputs.gt_p[:n]).rmse for b in range(B)])
    done = st["frames"]
    # the window's frames are the last ``done`` of all frames stepped since the warm-up
    all_p = np.concatenate([p for _, p, _ in segments])
    all_q = np.concatenate([q for _, _, q in segments])
    window_p, window_q = all_p[len(all_p) - done:], all_q[len(all_q) - done:]
    failed = int((~(np.isfinite(window_p).all(-1) & np.isfinite(window_q).all(-1))).sum())
    return Run(
        setup_s=setup_s,
        window=Window(w1 - w0, done, B, frame_ms if per_frame else None, peak, resident, st["sequences"]),
        trace=traced, attempted=done * B, failed=failed, ates=np.asarray(ates),
        checks=checks, init=init, inputs=inputs, device=device,
        kind=torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    )


def _traced_frames(n: int, roofline_frames: int, do_frame, device):
    """``n`` frames under the profiler, inside the stage ranges, the LK
    launch capture (inputs kept for the first ``roofline_frames``) and the
    sync counter.  Returns (Trace without its roofline, the capture)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .roofline.capture import capture
    from .trace import events as ev
    from .trace.stages import stage_ranges
    from .trace.syncs import count_syncs, package_sites

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with stage_ranges() as log, capture() as cap, profile(activities=activities) as prof:
        def frames():
            with record_function(ev.WINDOW_RANGE):
                for i in range(n):
                    cap.active = i < roofline_frames
                    do_frame(False)
                cap.active = False
                _sync(device)

        if device.type == "cuda":
            sites = count_syncs(frames)
        else:  # torch's sync debug mode is the card's
            sites = None
            frames()
    events = ev.from_kineto(prof.profiler.kineto_results.events())
    inside = None if sites is None else package_sites(sites)
    return Trace(events, list(log), n, None if inside is None else sum(inside.values()), inside or {}, {}), cap
