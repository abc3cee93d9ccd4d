"""The spans the port opens inside its frame step (``utils/timing.py:span``)
on the CPU, at B=2 over 3 frames of the stage split's bench scene from the
state its first frames leave (a 4-camera window, so the camera prune runs
within the profiled frames): under ``torch.profiler`` every stage span and
host-read span is recorded, each inside its parent; the LM exit read is
recorded once an LM iteration, as many times as the most LM steps of any
track that the profiled call logs in ``triangulation.lm_work_log``; the
poses and tracks are bit for bit an unprofiled run's; without a profiler ``span`` opens nothing; and
``PhaseTimer.phase`` still totals its phases, each phase a span when a
profiler records.  ``_cuda.launch`` opens each hand kernel's
``kernel.<name>`` span around a stand-in entry here, and around the kernel
itself on the card (``tests/test_torch_kernels.py``)."""
import time
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _lm_cases import lm_problem
from msckf_stereo_c_torch.bench import bench_scene
from msckf_stereo_c_torch.config import FilterConfig, FrontendConfig
from msckf_stereo_c_torch.models import triangulation
from msckf_stereo_c_torch.scripts import stage_split as ss
from msckf_stereo_c_torch.utils import timing

HEAD, SPLIT, B = 4, 3, 2

# span -> the spans that may enclose it directly
PARENTS = {ss.FRONTEND_TOTAL: ("vio.step",), ss.FILTER_TOTAL: ("vio.step",),
           "host_read.prune_any": (ss.FILTER_TOTAL,), "host_read.lm_exit": ("filter.triangulate",)}
for _label in ss.LABELS:
    if _label not in ss.TOTALS:
        PARENTS.setdefault(_label.split("/")[-1], ())
        PARENTS[_label.split("/")[-1]] += (ss.parent_of(_label),)


def _host_spans(prof):
    """{name: [(start, end)]} of the profile's host ops and spans."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU and e.linked_correlation_id() == 0:
            out[e.name()].append((e.start_ns(), e.end_ns()))
    return out


@pytest.fixture(scope="module")
def runs():
    """(unprofiled result, profiled result, the profile's host spans, LM
    iterations the profiled run made)."""
    scene = bench_scene(HEAD + SPLIT)
    fcfg = FrontendConfig(temporal_levels=1)
    mcfg = FilterConfig(ns_iters=10, max_cam_state_size=4, matmul_precision="tensorfloat32")
    state = ss.head_state(scene, HEAD, fcfg, mcfg, "schur", "cpu")
    tail = ss.tail_run(scene, state, HEAD, B, fcfg, mcfg, "schur", "cpu")
    plain = tail()
    solve, iterations = triangulation.solve3x3, []

    def counted(*args):  # one solve an LM iteration
        iterations.append(1)
        return solve(*args)

    triangulation.solve3x3 = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            profiled = tail()
    finally:
        triangulation.solve3x3 = solve
    return plain, profiled, _host_spans(prof), len(iterations)


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_recorded_inside_its_parent(runs, name):
    spans = runs[2]
    assert spans[name], f"no {name} span"
    outer = [iv for parent in PARENTS[name] for iv in spans[parent]]
    for s, e in spans[name]:
        assert any(a <= s and e <= b for a, b in outer), (name, PARENTS[name])


def test_one_step_and_one_prune_read_a_frame(runs):
    spans = runs[2]
    assert len(spans["vio.step"]) == len(spans[ss.FRONTEND_TOTAL]) == len(spans[ss.FILTER_TOTAL]) == SPLIT
    assert len(spans["host_read.prune_any"]) == SPLIT
    assert len(spans["filter.camera_prune"]) >= 1


def test_lm_exit_read_once_an_iteration(runs):
    spans, iterations = runs[2], runs[3]
    assert iterations > 0
    assert len(spans["host_read.lm_exit"]) == iterations


def test_profiled_run_is_bit_identical(runs):
    (_, plain_poses, plain_fronts, _), (_, poses, fronts, _) = runs[0], runs[1]
    for a, b in ((plain_poses, poses), (plain_fronts, fronts)):
        for field, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), field
    assert poses.p.shape == (B, SPLIT, 3)


def test_span_opens_nothing_without_a_profiler(monkeypatch):
    def opened(name):
        raise AssertionError(f"opened a range for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", opened)
    off = timing.span("vio.step")
    assert off is timing.span("filter")  # one shared null context
    with off:
        pass


def test_span_opens_a_range_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = timing.span("host_read.test")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            torch.ones(2).sum()
    assert len(_host_spans(prof)["host_read.test"]) == 1


def test_phase_timer_totals_phases_and_opens_spans():
    timer = timing.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with timer.phase("decode", sync="cpu"):
                time.sleep(0.002)
    with timer.phase("vio_chunk"):
        pass
    assert timer.counts == {"decode": 2, "vio_chunk": 1}
    assert timer.totals["decode"] >= 0.004 and timer.totals["vio_chunk"] >= 0
    assert len(_host_spans(prof)["decode"]) == 2


def test_launch_counts_and_spans_each_hand_kernel(monkeypatch):
    """``_cuda.launch`` with a stand-in for the C entry: the launch runs
    inside its ``kernel.<name>`` span while a profiler records, counts once,
    and a failed launch raises without counting."""
    from msckf_stereo_c_torch.ops import _cuda

    calls = []

    def entry(*args):
        calls.append(args)
        return int(args[0])

    monkeypatch.setattr(_cuda, "kernel_function", lambda name: entry)
    before = _cuda.launch_counts["extract_template"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _cuda.launch("extract_template", 0, "arg")
    _cuda.launch("extract_template", 0, "arg")
    with pytest.raises(RuntimeError, match="extract_template failed to launch"):
        _cuda.launch("extract_template", 700)
    assert calls == [(0, "arg"), (0, "arg"), (700,)]
    assert _cuda.launch_counts["extract_template"] == before + 2
    assert len(_host_spans(prof)["kernel.extract_template"]) == 1


def _same(x, y):
    return torch.equal(x.nan_to_num(), y.nan_to_num()) if x.is_floating_point() else torch.equal(x, y)


def test_lm_work_log_one_entry_a_call_only_under_a_profiler():
    """``triangulate_tracks`` logs each call's int32 (B, K) LM steps while a
    profiler records, and nothing otherwise; the results stay bit for bit
    those of an unprofiled call.  A lane outside ``active`` makes no step."""
    args = lm_problem(5, 16, 8, seed=2)
    log = triangulation.lm_work_log
    log.clear()
    plain = triangulation.triangulate_tracks(*args)
    assert len(log) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = triangulation.triangulate_tracks(*args)
        triangulation.triangulate_tracks(*args[:-1])  # every lane active
    assert len(log) == 2
    assert all(x.dtype == torch.int32 and x.shape == (5, 16) for x in log)
    inactive = ~args[-1]
    assert bool((log[0][inactive] == 0).all()) and bool((log[0][~inactive] >= 1).all())
    assert bool((log[1] >= 1).all()) and torch.equal(log[0][~inactive], log[1][~inactive])
    for x, y in zip(plain, got):
        assert _same(x, y)


@pytest.mark.parametrize("B,seed", [(1, 4), (5, 2), (8, 9)])
def test_lm_exit_reads_equal_the_most_steps_of_a_call(B, seed):
    """On the CPU the plain loop runs until no track is active: its exit
    reads, one an iteration, equal the largest per-track count it logs."""
    args = lm_problem(B, 16, 8, seed=seed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        triangulation.triangulate_tracks(*args)
    steps = triangulation.lm_work_log[-1]
    assert int(steps.max()) >= 1
    assert len(_host_spans(prof)["host_read.lm_exit"]) == int(steps.max())
