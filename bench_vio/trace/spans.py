"""What the program records about itself in a traced run: the
``record_function`` ranges ``msckf_stereo_c_torch`` opens inside its frame
step (``utils/timing.py:span``).  ``vio.step`` spans each batched frame;
under it the stages (``frontend.fast``, ``filter.lost``, ...), a
``host_read.<site>`` around each device-to-host read and a
``kernel.<name>`` around each hand-kernel launch.

A program without these spans records none of them, and every reader here
then returns None.  Each reader takes the traced run's records
(``harness.Trace``: ``events`` as ``trace.events.Event``, ``frames``) and
gives a number per traced frame."""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import List, Optional, Tuple

from .events import busy_intervals
from .stages import kernel_key

STEP = "vio.step"
HOST_READ = "host_read."
KERNEL = "kernel."
LM_EXIT = "host_read.lm_exit"
LM_CALLERS = ("filter.lost", "filter.camera_prune")  # the two callers of the LM triangulation
# The CUDA API calls that launch a kernel (cudaLaunchKernel,
# cudaLaunchKernelExC, cuLaunchKernel, ...).
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")

Intervals = List[Tuple[int, int]]


def spans(events, name: str = None, prefix: str = None) -> Intervals:
    """Sorted (start, end) of the host spans called ``name``, or whose name
    starts with ``prefix``."""
    return sorted((e.start_ns, e.end_ns) for e in events if e.kind == "cpu" and (
        e.name == name if prefix is None else e.name.startswith(prefix)))


def inside(iv: Intervals, t: int) -> bool:
    """``t`` lies in one of the sorted, disjoint intervals ``iv``."""
    i = bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and t <= iv[i][1]


def _merged(iv: Intervals) -> Intervals:
    out: Intervals = []
    for s, t in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _steps(trace) -> Optional[Intervals]:
    """The ``vio.step`` spans of the trace; None without a trace or any."""
    if trace is None:
        return None
    return spans(trace.events, STEP) or None


def host_reads_per_frame(trace) -> Optional[float]:
    """``host_read.*`` spans that start inside ``vio.step``, per frame."""
    steps = _steps(trace)
    if steps is None:
        return None
    reads = spans(trace.events, prefix=HOST_READ)
    return sum(inside(steps, s) for s, _ in reads) / trace.frames


def lm_iterations_per_frame(trace) -> Optional[float]:
    """LM iterations of the triangulation per frame: its exit reads
    (``host_read.lm_exit``, one an iteration) under the lost-track update
    and the camera prune together."""
    if _steps(trace) is None:
        return None
    callers = _merged(sorted(iv for name in LM_CALLERS for iv in spans(trace.events, name)))
    return sum(inside(callers, s) for s, _ in spans(trace.events, LM_EXIT)) / trace.frames


def _idle_ns(busy: Intervals, lo: int, hi: int) -> int:
    """The part of [lo, hi] that no interval of the sorted, disjoint
    ``busy`` covers."""
    i = bisect_right(busy, (lo, float("inf"))) - 1
    covered = 0
    for s, t in busy[max(i, 0):]:
        if s >= hi:
            break
        covered += max(0, min(t, hi) - max(s, lo))
    return (hi - lo) - covered


def dispatch_idle_ms(trace) -> Optional[float]:
    """Device-idle ms per frame inside ``vio.step`` and outside every
    ``host_read.*`` span: the card waiting for the host's dispatch within
    the step.  Idle time between steps (the harness's own work) and under
    the step's reads falls outside it."""
    steps = _steps(trace)
    if steps is None:
        return None
    ev = trace.events
    busy = busy_intervals(ev, steps[0][0], steps[-1][1])
    if not busy:
        return None
    reads = _merged(spans(ev, prefix=HOST_READ))
    idle = 0
    for lo, hi in steps:
        idle += _idle_ns(busy, lo, hi)
        idle -= sum(_idle_ns(busy, max(s, lo), min(t, hi)) for s, t in reads if s < hi and t > lo)
    return idle / 1e6 / trace.frames


def launches_per_frame(trace) -> Optional[float]:
    """Kernel launches per frame inside ``vio.step``: the runtime's launch
    calls, and each hand kernel's ``kernel.<name>`` span (a launch call
    inside such a span is that kernel's own and counts once).  None
    without any (a run off the card)."""
    steps = _steps(trace)
    if steps is None:
        return None
    hand = _merged(spans(trace.events, prefix=KERNEL))
    calls = sum(inside(steps, e.start_ns) and not inside(hand, e.start_ns) for e in trace.events
                if e.kind == "runtime" and e.name.startswith(LAUNCH_CALLS))
    n = calls + sum(inside(steps, s) for s, _ in hand)
    return n / trace.frames if n else None


def device_ms_under(trace, name: str) -> Optional[float]:
    """Device ms per frame of the device events whose launching op starts
    inside a span called ``name``.  A hand kernel's event with no
    launching op takes the start of its launch's ``kernel.<name>`` span:
    the k-th event of a kernel belongs to its k-th span (one stream runs
    them in launch order).  None without such a span or device event."""
    if trace is None:
        return None
    ev = trace.events
    under = spans(ev, name)
    device = sorted((e.start_ns, e.end_ns - e.start_ns, e.name, e.linked) for e in ev if e.kind == "device")
    if not under or not device:
        return None
    op_start = {e.corr: e.start_ns for e in ev if e.kind == "cpu"}
    launched = defaultdict(list)  # kernel_key -> starts of its kernel.<name> spans, in launch order
    for s, span in sorted((e.start_ns, e.name) for e in ev if e.kind == "cpu" and e.name.startswith(KERNEL)):
        launched[f"{span[len(KERNEL):]}_kernel("].append(s)
    taken = defaultdict(int)
    ns = 0
    for _, dur, kernel, linked in device:
        t = op_start.get(linked)
        if t is None:
            key = kernel_key(kernel)
            queue = launched.get(key, ())
            if taken[key] < len(queue):
                t = queue[taken[key]]
                taken[key] += 1
        if t is not None and inside(under, t):
            ns += dur
    return ns / 1e6 / trace.frames
