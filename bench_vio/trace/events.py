"""The traced run's events as plain records, and what the harness reads
from them itself: the traced window, the device's busy time (the union of
the intervals in which a kernel, copy or set runs, so that overlapping
work counts once) and the breakdown the result line carries.

A record is what ``stage_table`` and the metric readers take, so a test can
hand them a list made by hand."""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List, NamedTuple, Optional, Tuple

# The range the harness opens around the traced frames: its extent is the
# traced window.
WINDOW_RANGE = "bench: traced frames"


class Event(NamedTuple):
    kind: str  # "cpu" (an op or a range), "runtime" (a runtime call), "device", "annotation"
    name: str
    start_ns: int
    end_ns: int
    corr: int  # correlation id
    linked: int  # a device event: the correlation id of the host op that launched it


def from_kineto(events) -> List[Event]:
    """Records of ``prof.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CPU:
            k = "cpu" if e.linked_correlation_id() == 0 else "runtime"
        elif kind == DeviceType.CUDA:
            k = "annotation" if e.is_user_annotation() else "device"
        else:
            continue
        start = e.start_ns()
        end = start + e.duration_ns() if k in ("device", "annotation") else e.end_ns()
        out.append(Event(k, e.name(), start, end, e.correlation_id(), e.linked_correlation_id()))
    return out


def window(events: Iterable[Event]) -> Optional[Tuple[int, int]]:
    """(start, end) in ns of the traced window's range; None without it."""
    spans = [(e.start_ns, e.end_ns) for e in events if e.kind == "cpu" and e.name == WINDOW_RANGE]
    if not spans:
        return None
    return min(s for s, _ in spans), max(t for _, t in spans)


def busy_intervals(events: Iterable[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the device events' intervals, clipped to [lo, hi], as
    sorted disjoint intervals."""
    iv = sorted((max(e.start_ns, lo), min(e.end_ns, hi)) for e in events
                if e.kind == "device" and e.end_ns > lo and e.start_ns < hi)
    merged: List[Tuple[int, int]] = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1] = (merged[-1][0], t)
        else:
            merged.append((s, t))
    return merged


def busy_ns(events: Iterable[Event], lo: int, hi: int) -> int:
    return sum(t - s for s, t in busy_intervals(events, lo, hi))


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def breakdown(events: List[Event], lo: int, hi: int, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time, summed by
    name; ``idle_gaps``: the idle time between device intervals, summed by
    what the host was doing at each gap's middle (the innermost stage range
    and the innermost host op open there), largest first; seconds each."""
    from .stages import LABELS

    ops = Counter()
    for e in events:
        if e.kind == "device" and e.end_ns > lo and e.start_ns < hi:
            ops[_short(e.name)] += (min(e.end_ns, hi) - max(e.start_ns, lo)) / 1e9
    host = sorted((e.start_ns, e.end_ns, e.name) for e in events
                  if e.kind == "cpu" and e.name != WINDOW_RANGE and e.end_ns > lo and e.start_ns < hi)
    gaps = Counter()
    prev = lo
    nxt = 0
    open_ = []  # host events started before the current gap's middle, in start order
    for s, t in busy_intervals(events, lo, hi) + [(hi, hi)]:
        if s > prev:
            mid = (s + prev) // 2
            while nxt < len(host) and host[nxt][0] <= mid:
                open_.append(host[nxt])
                nxt += 1
            open_ = [h for h in open_ if h[1] >= mid]
            stage, op, op_len = "no stage", "no host op", None
            for a, b, name in open_:
                if name in LABELS:
                    stage = name  # ranges nest: the later start is the inner one
                elif op_len is None or b - a <= op_len:
                    op, op_len = name, b - a
            gaps[_short(f"{stage} / {op}")] += (s - prev) / 1e9
        prev = max(prev, t)
    return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}
