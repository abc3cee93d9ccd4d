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
warm-up at that B, one run under ``torch.profiler``, which turns on the
spans the program opens around its stages (``utils/timing.py:span``;
``LABELS``): nothing is synchronised and the program is unchanged, so the
run gives the poses an unprofiled run gives.  The JAX scripts cut the
program short to isolate a phase; the spans measure the whole program
instead.

Prints per B and stage the host ms and device ms per batched frame (the
device work launched inside the span; a hand kernel's placed by its
``kernel.<name>`` span), the device ops, and the share of the step's
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

# Stage functions of one frame: (module, attribute, key, label), in the
# order a frame runs them, the two totals last.  The stage function is the
# module attribute, or its entry ``key`` where the attribute is a dict (the
# front end calls its LK through the ``_KLT_IMPLS`` table).  ``wrapped``
# replaces them for ``chip_smoke.py``'s synchronised stage times; the split
# itself reads the program's own spans.
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
    ("msckf_stereo_c_torch.models.msckf", "_remove_lost_features", None, "filter: lost-track update"),
    ("msckf_stereo_c_torch.models.msckf", "_prune_cam_states", None, "filter: camera prune"),
    ("msckf_stereo_c_torch.models.msckf", "_online_reset", None, "filter: online reset"),
    ("msckf_stereo_c_torch.models.vio", "_run_frontend", None, "frontend total"),
    ("msckf_stereo_c_torch.models.vio", "batched_filter_step", None, "filter total"),
)

# The program's spans (``utils/timing.py:span``) a frame opens under
# ``vio.step``, as the split's labels: a stage's span name, or
# ``<parent>/<span>`` for the three parts of an update, which the
# lost-track update and the camera prune both run.  Parents come before
# their parts, the two totals last.
FRONTEND_TOTAL = "frontend"
FILTER_TOTAL = "filter"
UPDATE_PARTS = ("filter.triangulate", "filter.schur_gating", "filter.update")
UPDATES = ("filter.lost", "filter.camera_prune")
LABELS = (
    "frontend.pyramids", "frontend.temporal_lk", "frontend.fast", "frontend.stereo",
    "frontend.allocate", "frontend.prune", "frontend.publish",
    "filter.observe",
    "filter.lost", *(f"filter.lost/{part}" for part in UPDATE_PARTS),
    "filter.camera_prune", *(f"filter.camera_prune/{part}" for part in UPDATE_PARTS),
    "filter.publish", "filter.online_reset",
    FRONTEND_TOTAL, FILTER_TOTAL,
)
TOTALS = (FRONTEND_TOTAL, FILTER_TOTAL)
KERNEL = "kernel."  # the span around each hand-kernel launch: ``kernel.<name>``


def parent_of(label: str):
    """The label whose span encloses ``label``'s (None for the totals)."""
    if label in TOTALS:
        return None
    if "/" in label:
        return label.split("/")[0]
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


def kernel_key(name: str) -> str:
    """``<kernel>(`` of a device event's name, without a leading ``void``
    and template arguments: ``lk_corr_align_kernel(`` of ``void
    lk_corr_align_kernel<0>(float const*, ...)``."""
    head = name[: name.find("(")] if "(" in name else name
    head = head.removeprefix("void ")
    if "<" in head:
        head = head[: head.find("<")]
    return head + "("


def stage_table(events, frames: int) -> dict:
    """Per label of ``LABELS`` (its spans' calls, host ms, device ms and
    device ops per frame, share of the step's device time) and the step's
    device total, ops, the device time in no stage and the kernels that
    take it, from a profile's raw events
    (``prof.profiler.kineto_results.events()``: reading them takes seconds
    where building ``prof.events()`` takes minutes at B=1024).

    A device event belongs to the spans around the host op that launched
    it.  A hand kernel may have no such op: the k-th device event of kernel
    ``name`` then belongs to the spans around the k-th ``kernel.<name>``
    span (one stream runs them in launch order).  Anything else, or a
    device event in neither total's span, is in no stage."""
    from bisect import bisect_right
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType

    names = {label.split("/")[-1] for label in LABELS}
    named = defaultdict(list)  # span name -> (start, end)
    launched = defaultdict(list)  # kernel_key -> starts of its kernel.<name> spans
    op_start = {}  # correlation id of a host op or span -> its start
    device = []  # (start, ns, name, correlation id of the launching op)
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CPU:
            if e.linked_correlation_id() == 0:  # an op or a span, not a runtime call
                start = e.start_ns()
                op_start[e.correlation_id()] = start
                if e.name() in names:
                    named[e.name()].append((start, e.end_ns()))
                elif e.name().startswith(KERNEL):
                    launched[e.name()[len(KERNEL):] + "_kernel("].append(start)
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.duration_ns(), e.name(), e.linked_correlation_id()))
    for starts in launched.values():
        starts.sort()

    spans, starts = {}, {}  # label -> its spans (inside its parent's), their starts

    def inside(label, t) -> bool:
        i = bisect_right(starts[label], t) - 1
        return i >= 0 and t <= spans[label][i][1]

    for label in LABELS:  # parents first
        parent = parent_of(label) if "/" in label else None
        spans[label] = sorted(iv for iv in named[label.split("/")[-1]] if parent is None or inside(parent, iv[0]))
        starts[label] = [lo for lo, _ in spans[label]]

    dev_ns = Counter()
    dev_ops = Counter()
    rest = Counter()
    taken = Counter()
    total_ns = 0
    for _, ns, name, corr in sorted(device):
        total_ns += ns
        t = op_start.get(corr)
        if t is None:
            key = kernel_key(name)
            queue = launched.get(key, ())
            if taken[key] < len(queue):
                t = queue[taken[key]]
                taken[key] += 1
        hit = [] if t is None else [lb for lb in LABELS if inside(lb, t)]
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
        hand_launches=sum(len(q) for q in launched.values()), hand_events=sum(taken.values()),
        hand_rest_ms=sum(v for n, v in rest.items() if kernel_key(n) in launched) / 1e6 / frames,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_stages(run: Callable[[], object], frames: int, device) -> tuple:
    """``run()`` once under ``torch.profiler`` (host and device activity),
    which turns the program's spans on; returns (its result,
    ``stage_table`` with the profiled wall ms per frame and the kernel
    launches of the run)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import _cuda

    device = torch.device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    _cuda.reset_launch_counts()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = run()
        _sync(device)
        wall = time.perf_counter() - t0
    launches = dict(_cuda.launch_counts)
    table = stage_table(prof.profiler.kineto_results.events(), frames)
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
    """Warm-up, then one profiled run of ``run``; prints the table and
    returns (the run's result, its table)."""
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
