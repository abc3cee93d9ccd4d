"""Where the time of a batched frame goes, stage by stage, at B lanes (port of
what ``scripts/split_bench.py``, ``filter_phase_split.py`` and
``lost_phase_split.py`` measure).

    SPLIT_BATCH=1,16,256,1024 SPLIT_FRAMES=8 python -m msckf_stereo_c_torch.scripts.stage_split

Runs ``bench.py``'s configuration and scene (``bench.bench_configs``, its
``BENCH_*`` knobs, and ``bench.bench_scene``) through
``parallel/vio_multiseq.py:run_vio_batch`` at each B of ``SPLIT_BATCH``
over ``SPLIT_FRAMES`` frames, starting from the state the first
HEAD_FRAMES frames of the scene leave (window full, every frame prunes),
broadcast to B lanes that share the images and the IMU.  After a two-frame
warm-up at that B, one run under ``torch.profiler`` with each stage
function (``STAGES``, and ``LOST_STAGES`` inside the lost-track update)
wrapped in a ``record_function`` range: nothing is synchronised and the
program is unchanged, so the run gives the poses an unwrapped run gives.
The JAX scripts cut the program short to isolate a phase; the ranges
measure the whole program instead.

Prints per B and stage the host ms and device ms per batched frame (the
device work launched inside the range; a hand kernel's by the launch log
``stage_ranges`` keeps), the device ops, and the share of the step's
device time; then the step's own device total, the device time in no
stage and the kernels that take it.  Runs on the CUDA card;
``main(device="cpu")`` runs on the CPU (no device time there).
"""
from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Callable, Mapping

import numpy as np
import torch

HEAD_FRAMES = 52  # frames before the split's: the camera window is full from here on
WARMUP_FRAMES = 2

FRONTEND_TOTAL = "frontend total"
FILTER_TOTAL = "filter total"
LOST_PARENT = "filter: lost-track update"

# Stages of one frame: (module, attribute, key, label), in the order a
# frame runs them, the two totals last.  The stage function is the module
# attribute, or its entry ``key`` where the attribute is a dict (the front
# end calls its LK through the ``_KLT_IMPLS`` table).
STAGES = (
    ("msckf_stereo_c_torch.models.vio", "pyramids_for", None, "frontend: pyramids"),
    ("msckf_stereo_c_torch.models.frontend", "optical_flow_lk_corr_l0", None, "frontend: temporal LK"),
    ("msckf_stereo_c_torch.models.frontend", "_detect_candidates", None, "frontend: FAST candidates"),
    ("msckf_stereo_c_torch.models.frontend", "_KLT_IMPLS", "corr", "frontend: candidate coarse walk"),
    ("msckf_stereo_c_torch.models.frontend", "stereo_anchor_lr_fused", None, "frontend: fused stereo fine level"),
    ("msckf_stereo_c_torch.models.frontend", "_allocate_new_features", None, "frontend: allocate"),
    ("msckf_stereo_c_torch.models.frontend", "_prune_grid_features", None, "frontend: prune"),
    ("msckf_stereo_c_torch.models.frontend", "_publish", None, "frontend: publish"),
    ("msckf_stereo_c_torch.models.msckf", "batched_propagate", None, "filter: propagate"),
    ("msckf_stereo_c_torch.models.msckf", "augment_state", None, "filter: augment"),
    ("msckf_stereo_c_torch.models.msckf", "add_feature_observations", None, "filter: observe"),
    ("msckf_stereo_c_torch.models.msckf", "_remove_lost_features", None, LOST_PARENT),
    ("msckf_stereo_c_torch.models.msckf", "_prune_cam_states", None, "filter: camera prune"),
    ("msckf_stereo_c_torch.models.msckf", "_online_reset", None, "filter: online reset"),
    ("msckf_stereo_c_torch.models.vio", "_run_frontend", None, FRONTEND_TOTAL),
    ("msckf_stereo_c_torch.models.vio", "batched_filter_step", None, FILTER_TOTAL),
)
# The lost-track update's sub-phases (lost_phase_split.py's), ranged only
# inside it: the camera prune calls some of them too.
LOST_STAGES = (
    ("msckf_stereo_c_torch.models.msckf", "check_motion_tracks", None, "lost: motion check"),
    ("msckf_stereo_c_torch.models.msckf", "triangulate_tracks", None, "lost: triangulate"),
    ("msckf_stereo_c_torch.models.msckf", "track_blocks", None, "lost: track blocks"),
    ("msckf_stereo_c_torch.models.msckf", "schur_gating", None, "lost: Schur gating"),
    ("msckf_stereo_c_torch.models.msckf", "measurement_update_schur", None, "lost: Schur update"),
)
TOTALS = (FRONTEND_TOTAL, FILTER_TOTAL)
LABELS = tuple(stage[-1] for stage in STAGES + LOST_STAGES)


def parent_of(label: str):
    """The label whose range encloses ``label``'s (None for the totals)."""
    if label in TOTALS:
        return None
    if label.startswith("lost: "):
        return LOST_PARENT
    return FRONTEND_TOTAL if label.startswith("frontend") else FILTER_TOTAL


def stage_function(stage):
    """The function a stage entry names, as it stands now."""
    mod_name, attr, key, _ = stage
    obj = getattr(importlib.import_module(mod_name), attr)
    return obj if key is None else obj[key]


def _set_stage_function(stage, fn) -> None:
    mod_name, attr, key, _ = stage
    mod = importlib.import_module(mod_name)
    if key is None:
        setattr(mod, attr, fn)
    else:
        getattr(mod, attr)[key] = fn


@contextlib.contextmanager
def wrapped(stages, make_wrapper):
    """Within the scope each stage function of ``stages`` is replaced by
    ``make_wrapper(fn, label)``; each is restored on exit, also when the
    scope raises."""
    saved = []
    try:
        for stage in stages:
            fn = stage_function(stage)
            saved.append((stage, fn))
            _set_stage_function(stage, make_wrapper(fn, stage[-1]))
        yield
    finally:
        for stage, fn in reversed(saved):
            _set_stage_function(stage, fn)


@contextlib.contextmanager
def stage_ranges():
    """Within the scope every stage function runs inside a
    ``torch.profiler.record_function`` range of its label (the lost-track
    sub-phases only inside the lost-track update); restored on exit.

    Yields the log of hand-kernel launches made in the scope: (kernel,
    labels of the ranges around the launch), in launch order.  The
    profiler does not always link a host op to these kernels (their
    libraries carry their own CUDA runtime), so ``stage_table`` places the
    unlinked ones by this log."""
    from ..ops import _cuda

    active = set()
    log = []

    def ranged(fn, label):
        inside = parent_of(label) if label.startswith("lost: ") else None

        def wrapper(*args, **kwargs):
            if inside is not None and inside not in active:
                return fn(*args, **kwargs)
            active.add(label)
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                active.discard(label)

        return wrapper

    kernel_function = _cuda.kernel_function

    def logged_kernel_function(name):
        fn = kernel_function(name)

        def launch(*args):
            log.append((name, tuple(sorted(active))))
            return fn(*args)

        return launch

    _cuda.kernel_function = logged_kernel_function
    try:
        with wrapped(STAGES + LOST_STAGES, ranged):
            yield log
    finally:
        _cuda.kernel_function = kernel_function


def stage_table(events, frames: int, launches=()) -> dict:
    """Per label of ``LABELS`` (its ranges' calls, host ms, device ms and
    device ops per frame, share of the step's device time) and the step's
    device total, ops, the device time in no stage and the kernels that
    take it, from a profile's raw events
    (``prof.profiler.kineto_results.events()``: reading them takes seconds
    where building ``prof.events()`` takes minutes at B=1024).

    A device event belongs to the ranges around the host op that launched
    it.  A hand kernel has no such op: the k-th device event of kernel
    ``name`` belongs to the ranges of the k-th ``(name, labels)`` of
    ``launches`` (``stage_ranges``' log; one stream runs them in launch
    order).  Anything else, or a device event in neither total's range, is
    in no stage."""
    from bisect import bisect_right
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType

    spans = {label: [] for label in LABELS}
    op_start = {}  # correlation id of a host op or range -> its start
    device = []  # (start, ns, name, correlation id of the launching op)
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CPU:
            if e.linked_correlation_id() == 0:  # an op or a range, not a runtime call
                start = e.start_ns()
                op_start[e.correlation_id()] = start
                if e.name() in spans:
                    spans[e.name()].append((start, e.end_ns()))
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.duration_ns(), e.name(), e.linked_correlation_id()))
    for s in spans.values():
        s.sort()
    starts = {label: [lo for lo, _ in s] for label, s in spans.items()}
    logged = defaultdict(list)
    for name, labels in launches:
        logged[f"{name}_kernel("].append(labels)
    taken = Counter()

    def inside(label, t) -> bool:
        i = bisect_right(starts[label], t) - 1
        return i >= 0 and t <= spans[label][i][1]

    def labels_at(t):
        tops = [total for total in TOTALS if inside(total, t)]
        hit = list(tops)
        for lb in LABELS:
            if lb not in TOTALS and parent_of(lb) in hit and inside(lb, t):
                hit.append(lb)
        return hit

    dev_ns = Counter()
    dev_ops = Counter()
    rest = Counter()
    total_ns = 0
    for _, ns, name, corr in sorted(device):
        total_ns += ns
        t = op_start.get(corr)
        if t is not None:
            hit = labels_at(t)
        else:
            key = name[: name.find("(") + 1]
            queue = logged.get(key, ())
            hit = list(queue[taken[key]]) if taken[key] < len(queue) else []
            taken[key] += bool(queue)
        for lb in hit:
            dev_ns[lb] += ns
            dev_ops[lb] += 1
        if not any(lb in TOTALS for lb in hit):
            rest[name] += ns
    rows = {}
    for label in LABELS:
        rows[label] = dict(
            calls=len(spans[label]),
            host_ms=sum(hi - lo for lo, hi in spans[label]) / 1e6 / frames,
            device_ms=dev_ns[label] / 1e6 / frames,
            device_ops=dev_ops[label] / frames,
            share=dev_ns[label] / total_ns if total_ns else 0.0,
        )
    return dict(
        frames=frames, stages=rows, device_ms=total_ns / 1e6 / frames, device_ops=len(device) / frames,
        rest_ms=sum(rest.values()) / 1e6 / frames,
        rest_top=[dict(name=n, device_ms=v / 1e6 / frames) for n, v in rest.most_common(5)],
        hand_launches=len(launches), hand_events=sum(taken.values()),
        hand_rest_ms=sum(v for n, v in rest.items() if n[: n.find("(") + 1] in logged) / 1e6 / frames,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stages(run: Callable[[], object], frames: int, device) -> tuple:
    """``run()`` once with the stages ranged, under ``torch.profiler``
    (host and device activity); returns (its result, ``stage_table`` with
    the profiled wall ms per frame and the kernel launches of the run)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _cuda

    device = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    _cuda.reset_launch_counts()
    with stage_ranges() as log, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = run()
        _sync(device)
        wall = time.perf_counter() - t0
    launches = dict(_cuda.launch_counts)
    table = stage_table(prof.profiler.kineto_results.events(), frames, log)
    table.update(wall_ms=wall * 1e3 / frames, launches=launches)
    return result, table


def tail_run(scene, head_state, k0: int, batch: int, fcfg, mcfg, method: str, device):
    """bench.py's semantics from frame ``k0`` of ``scene`` on: a
    ``bench.BatchRun`` of ``head_state`` (the state the frames before ``k0``
    leave, float32) broadcast to ``batch`` lanes, the images and the IMU
    shared by every lane."""
    from ..bench import BatchRun
    from ..config import EUROC_CALIB
    from ..models.frontend import make_frontend_params
    from ..models.msckf import make_params
    from ..models.runner import pack_imu_batches
    from ..parallel.vio_multiseq import broadcast_state
    from ..utils.lanes import map_tree

    dev, f32 = torch.device(device), torch.float32
    frame_t = scene.frame_t
    T = frame_t.shape[0] - k0
    batches = pack_imu_batches(scene.imu.t, scene.imu.gyro, scene.imu.acc, frame_t[k0:], mcfg.max_imu_per_frame,
                               np.float32, prev_frame_t=float(frame_t[k0 - 1]), device=dev)
    return BatchRun(
        states=broadcast_state(head_state, batch),
        imgs0=torch.as_tensor(scene.img0[k0:], dtype=f32).to(dev),
        imgs1=torch.as_tensor(scene.img1[k0:], dtype=f32).to(dev),
        times=torch.as_tensor(frame_t[k0:], dtype=f32).to(dev).expand(batch, T),
        imu=map_tree(lambda x: x.expand(batch, *x.shape), batches),
        fparams=make_frontend_params(EUROC_CALIB, f32, dev),
        mparams=make_params(mcfg, EUROC_CALIB, f32, dev),
        fcfg=fcfg, mcfg=mcfg, method=method, device=dev,
    )


def head_state(scene, k0: int, fcfg, mcfg, method: str, device):
    """The state (float32) the first ``k0`` frames of ``scene`` leave."""
    from ..config import EUROC_CALIB
    from ..models.vio import run_vio_sequence

    ft = scene.frame_t
    return run_vio_sequence(fcfg, mcfg, EUROC_CALIB, ft[:k0], scene.img0[:k0], scene.img1[:k0], scene.imu.t,
                            scene.imu.gyro, scene.imu.acc, image_dtype=torch.float32, filter_dtype=torch.float32,
                            method=method, device=device).final_state


def split_at(run, tag: str = "split") -> tuple:
    """Warm-up, then one profiled run of ``run`` with the stages ranged;
    prints the table and returns (the run's result, its table)."""
    B, T = run.times.shape
    run(WARMUP_FRAMES)
    result, table = profile_stages(run, T, run.device)
    table["B"] = B
    total = table["device_ms"]
    print(f"[{tag}] B={B}: {T} frames, profiled wall {table['wall_ms']:.2f} ms per batched frame; step device "
          f"{total:.3f} ms and {table['device_ops']:.0f} device ops per batched frame; in no stage "
          f"{table['rest_ms']:.3f} ms")
    for r in table["rest_top"]:
        print(f"[{tag}]   in no stage: {r['device_ms']:.3f} ms  {r['name'][:100]}")
    print(f"[{tag}]   {'host ms':>9} {'device ms':>10} {'ops':>7} {'share':>6}  stage")
    for label, r in table["stages"].items():
        print(f"[{tag}]   {r['host_ms']:9.3f} {r['device_ms']:10.3f} {r['device_ops']:7.0f} "
              f"{100 * r['share']:5.1f}%  {label}")
    return result, table


def main(env: Mapping[str, str] = os.environ, device=None) -> dict:
    """The split at each B of ``SPLIT_BATCH`` over ``SPLIT_FRAMES`` frames;
    returns {B: table}."""
    from ..bench import bench_configs, bench_scene, card_description
    from ..config import resolve_device

    fcfg, mcfg, method = bench_configs(env)
    batches = [int(b) for b in env.get("SPLIT_BATCH", "1,16,256,1024").split(",")]
    frames = int(env.get("SPLIT_FRAMES", "8"))
    dev = resolve_device(device)
    print(f"[split] {card_description(dev)}; bench scene, {HEAD_FRAMES} head frames, {frames} split frames")
    scene = bench_scene(HEAD_FRAMES + frames)
    state = head_state(scene, HEAD_FRAMES, fcfg, mcfg, method, dev)
    out = {}
    for B in batches:
        _, out[B] = split_at(tail_run(scene, state, HEAD_FRAMES, B, fcfg, mcfg, method, dev))
    return out


if __name__ == "__main__":
    main()
