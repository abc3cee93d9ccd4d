"""The reader of the program's LM step log (``trace/lm_work.py``) on a
hand-made trace: two frames, each with a ``filter.triangulate`` span in the
lost-track update and one in the camera prune, against the log's last
entries, one a span; and absent where the program keeps no log (an older
commit) or the log is short."""
import collections
import types

import pytest
import torch

from bench_vio.harness import Trace, Window
from bench_vio.metrics import reader
from bench_vio.trace.events import WINDOW_RANGE, Event
from msckf_stereo_c_torch.models import triangulation

FRAMES = 2
NAMES = [f"lm_kernel_iterations_per_frame.{c}" for c in ("eval", "live")]


def _events():
    ev = [Event("cpu", WINDOW_RANGE, 0, 2000, 1, 0)]
    for f in range(FRAMES):
        base = 1000 * f
        for name, s, t in (("vio.step", 0, 800), ("filter.lost", 300, 470), ("filter.triangulate", 315, 460),
                           ("filter.camera_prune", 490, 700), ("filter.triangulate", 500, 690)):
            ev.append(Event("cpu", name, base + s, base + t, len(ev) + 2, 0))
    return ev


def _run(events):
    w = Window(seconds=2.0, frames=10, lanes=1, frame_ms=None, peak_bytes=None, resident_bytes=0, sequences=0)
    trace = None if events is None else Trace(events=events, launches=[], frames=FRAMES, syncs=None, sync_sites={},
                                              roofline={})
    return types.SimpleNamespace(window=w, trace=trace, setup_s=1.0)


@pytest.fixture
def log(monkeypatch):
    entries = collections.deque(maxlen=256)
    monkeypatch.setattr(triangulation, "lm_work_log", entries)
    return entries


@pytest.mark.parametrize("name", NAMES)
def test_sums_each_calls_most_steps(log, name):
    # an older call first, then the four traced calls: lost 7, prune 3, lost 12, prune 0 (empty)
    log.append(torch.full((2, 4), 30, dtype=torch.int32))
    log.extend([torch.tensor([[1, 7], [2, 0]], dtype=torch.int32), torch.tensor([[3]], dtype=torch.int32),
                torch.tensor([[12, 1, 5]], dtype=torch.int32), torch.zeros((1, 0), dtype=torch.int32)])
    assert reader(name)(_run(_events())) == pytest.approx((7 + 3 + 12 + 0) / FRAMES)


@pytest.mark.parametrize("name", NAMES)
def test_absent(log, monkeypatch, name):
    log.extend([torch.ones((1, 3), dtype=torch.int32)] * 3)
    assert reader(name)(_run(None)) is None  # no trace
    assert reader(name)(_run(_events())) is None  # fewer logged calls than spans
    log.append(torch.ones((1, 3), dtype=torch.int32))
    assert reader(name)(_run(_events())) == 2.0
    monkeypatch.delattr(triangulation, "lm_work_log")  # a program that keeps no log
    assert reader(name)(_run(_events())) is None
    older = [e for e in _events() if e.name != "filter.triangulate"]
    monkeypatch.setattr(triangulation, "lm_work_log", log, raising=False)
    assert reader(name)(_run(older)) is None  # a program without the span
