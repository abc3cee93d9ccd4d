# Frozen copy of msckf_stereo_c_torch/scripts/stage_split.py (STAGES to
# stage_table) at commit 50013dad8c92; stage_table reads trace/events.py's
# records in place of kineto's event objects, and the ranged functions are
# named by their full module path, as they were.
"""The benchmark's spans: ``record_function`` ranges put around the port's
stage functions from outside the program (``stage_ranges``), with a log of
the hand-kernel launches made inside them, and ``stage_table``, which
attributes the profiled device time to the ranges."""
from __future__ import annotations

import contextlib
import importlib

import torch

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
    from msckf_stereo_c_torch.ops import _cuda

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


def kernel_key(name: str) -> str:
    """``<kernel>(`` of a device event's name, without a leading ``void``
    and template arguments: the key of the launch log's ``<name>_kernel(``."""
    head = name[: name.find("(")] if "(" in name else name
    head = head.removeprefix("void ")
    if "<" in head:
        head = head[: head.find("<")]
    return head + "("


def stage_table(events, frames: int, launches=()) -> dict:
    """Per label of ``LABELS`` (its ranges' calls, host ms, device ms and
    device ops per frame, share of the step's device time) and the step's
    device total, ops, the device time in no stage and the kernels that
    take it, from a profile's raw events
    (``trace.events.from_kineto`` of ``prof.profiler.kineto_results.events()``:
    reading them takes seconds where building ``prof.events()`` takes minutes
    at B=1024).

    A device event belongs to the ranges around the host op that launched
    it.  A hand kernel has no such op: the k-th device event of kernel
    ``name`` belongs to the ranges of the k-th ``(name, labels)`` of
    ``launches`` (``stage_ranges``' log; one stream runs them in launch
    order).  Anything else, or a device event in neither total's range, is
    in no stage."""
    from bisect import bisect_right
    from collections import Counter, defaultdict

    spans = {label: [] for label in LABELS}
    op_start = {}  # correlation id of a host op or range -> its start
    device = []  # (start, ns, name, correlation id of the launching op)
    for e in events:
        if e.kind == "cpu":  # an op or a range, not a runtime call
            op_start[e.corr] = e.start_ns
            if e.name in spans:
                spans[e.name].append((e.start_ns, e.end_ns))
        elif e.kind == "device":
            device.append((e.start_ns, e.end_ns - e.start_ns, e.name, e.linked))
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
            key = kernel_key(name)
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
        hand_rest_ms=sum(v for n, v in rest.items() if kernel_key(n) in logged) / 1e6 / frames,
    )
