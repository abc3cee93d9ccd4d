"""The readers of the program's own spans (``trace/spans.py``) on a hand-made
event list: two frames, each a ``vio.step`` with the front end's FAST, a
hand-kernel launch, the LM exit reads of both updates and the prune read,
an idle gap half covered by a read, and harness work between the steps;
and absent where the program opens no spans (an older commit)."""
import types

import pytest

from bench_vio.harness import Trace, Window
from bench_vio.metrics import reader
from bench_vio.trace.events import WINDOW_RANGE, Event

FRAMES = 2
NAMES = ["fast_device_ms.eval", "launches_per_frame.live"] + [
    f"{n}.{c}" for n in ("host_reads_per_frame", "lm_iterations_per_frame", "dispatch_idle_ms") for c in ("eval", "live")]


def _frame(base: int, corr: int):
    """One frame's events, at ``base`` ns; correlation ids from ``corr``."""
    ev = []

    def cpu(name, s, t):
        ev.append(Event("cpu", name, base + s, base + t, corr + len(ev), 0))
        return ev[-1].corr

    def op(name, s, t, launch, device):  # a host op, its launch call and its kernel [device]
        c = cpu(name, s, t)
        ev.append(Event("runtime", "cudaLaunchKernel", base + launch, base + launch + 1, corr + len(ev), c))
        ev.append(Event("device", f"{name}_kernel", base + device[0], base + device[1], corr + len(ev), c))

    cpu("vio.step", 0, 800)
    cpu("frontend", 10, 300)
    cpu("frontend.fast", 50, 150)
    op("aten::roll", 60, 70, 61, (100, 180))  # FAST's device work runs after its span ends
    op("aten::mul", 200, 210, 201, (210, 250))
    cpu("kernel.lk_corr_align_gain", 260, 270)
    # the hand kernel's own launch call and its unlinked device event
    ev.append(Event("runtime", "cudaLaunchKernel", base + 262, base + 263, corr + len(ev), 0))
    ev.append(Event("device", "void lk_corr_align_gain_kernel<1>(float const*)", base + 270, base + 300,
                    corr + len(ev), 0))
    cpu("filter", 300, 790)
    cpu("filter.lost", 310, 470)
    cpu("filter.triangulate", 315, 460)
    op("aten::mm", 318, 325, 319, (320, 350))
    cpu("host_read.lm_exit", 330, 380)  # idle 350-360 under it
    op("aten::bmm", 326, 328, 327, (360, 420))
    cpu("host_read.lm_exit", 390, 410)  # busy under it
    op("aten::add", 462, 464, 463, (465, 490))
    cpu("host_read.prune_any", 470, 480)
    ev.append(Event("runtime", "cudaMemcpyAsync", base + 471, base + 479, corr + len(ev), 0))  # not a launch
    cpu("filter.camera_prune", 490, 700)
    cpu("filter.triangulate", 500, 690)
    cpu("host_read.lm_exit", 545, 600)  # covers half of the idle gap 490-600
    op("aten::copy_", 600, 601, 600, (600, 780))
    # harness work between the steps: a gather and a pose read, outside vio.step
    op("aten::index", 840, 846, 845, (850, 900))
    cpu("host_read.pose", 920, 930)
    cpu("host_read.lm_exit", 940, 950)  # under neither update
    return ev


def _events():
    ev = [Event("cpu", WINDOW_RANGE, 0, 2000, 1, 0)]
    for f in range(FRAMES):
        ev += _frame(1000 * f, 100 * (f + 1))
    return ev


def _run(events):
    w = Window(seconds=2.0, frames=10, lanes=1, frame_ms=None, peak_bytes=None, resident_bytes=0, sequences=0)
    trace = None if events is None else Trace(events=events, launches=[], frames=FRAMES, syncs=None, sync_sites={},
                                              roofline={})
    return types.SimpleNamespace(window=w, trace=trace, setup_s=1.0)


@pytest.mark.parametrize("cell", ["eval", "live"])
def test_counts(cell):
    run = _run(_events())
    # 3 LM exit reads and the prune read a step; the pose read and the last
    # LM read lie outside vio.step
    assert reader(f"host_reads_per_frame.{cell}")(run) == 4.0
    assert reader(f"lm_iterations_per_frame.{cell}")(run) == 3.0


@pytest.mark.parametrize("cell", ["eval", "live"])
def test_dispatch_idle(cell):
    # busy in a step: 80 + 40 + 30 + 30 + 60 + 25 + 180 = 445 of 800 ns, so
    # 355 idle; under the reads 10 + 0 + 0 + 55 (half of the gap 490-600);
    # the idle 800-850 and 900-1000 between steps is the harness's
    assert reader(f"dispatch_idle_ms.{cell}")(_run(_events())) == pytest.approx((355 - 65) / 1e6)


def test_launches():
    # 6 launch calls a step outside the hand kernel's span, and its span;
    # the call inside that span, the copy and the harness's launch do not count
    assert reader("launches_per_frame.live")(_run(_events())) == 7.0


def test_fast_device_ms():
    # the roll kernel launched from an op inside frontend.fast, though it runs after the span
    assert reader("fast_device_ms.eval")(_run(_events())) == pytest.approx(80 / 1e6)


def test_hand_kernel_placed_by_its_span():
    from bench_vio.trace.spans import device_ms_under

    assert device_ms_under(_run(_events()).trace, "frontend") == pytest.approx((80 + 40 + 30) / 1e6)
    assert device_ms_under(_run(_events()).trace, "filter.camera_prune") == pytest.approx(180 / 1e6)


@pytest.mark.parametrize("name", NAMES)
def test_absent(name):
    assert reader(name)(_run(None)) is None  # no trace
    older = [e for e in _events() if not e.name.startswith(("vio.", "frontend", "filter", "host_read.", "kernel."))]
    assert reader(name)(_run(older)) is None  # a program without spans
