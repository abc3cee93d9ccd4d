"""Each metric reader on hand-made records, and absent where there is
nothing to read."""
import types

import pytest

from bench_vio.harness import Trace, Window
from bench_vio.metrics import reader
from bench_vio.roofline.capture import Count
from bench_vio.roofline import lk
from bench_vio.trace.events import WINDOW_RANGE, Event

FRAMES = 2


def _events():
    ev = [Event("cpu", WINDOW_RANGE, 0, 1000, 1, 0)]
    corr = 10
    for f in range(FRAMES):
        base = f * 500
        ev += [Event("cpu", "frontend total", base, base + 200, corr, 0),
               Event("cpu", "aten::conv2d", base + 10, base + 20, corr + 1, 0),
               Event("device", "conv_kernel", base + 30, base + 70, corr + 100, corr + 1),
               Event("cpu", "filter total", base + 200, base + 450, corr + 2, 0),
               Event("cpu", "filter: lost-track update", base + 210, base + 400, corr + 3, 0),
               Event("cpu", "lost: Schur gating", base + 220, base + 300, corr + 4, 0),
               Event("cpu", "aten::bmm", base + 230, base + 240, corr + 5, 0),
               Event("device", "gemm_kernel", base + 250, base + 350, corr + 101, corr + 5),
               Event("cpu", "aten::mm", base + 410, base + 420, corr + 6, 0),
               Event("device", "mm_kernel", base + 420, base + 440, corr + 102, corr + 6),
               # overlaps the gemm: the busy union counts it once
               Event("device", "memcpy", base + 300, base + 360, corr + 103, corr + 6)]
        corr += 20
    return ev


def _run(trace=None, frame_ms=None, peak=None):
    w = Window(seconds=2.0, frames=10, lanes=4, frame_ms=frame_ms, peak_bytes=peak, resident_bytes=2**30, sequences=0)
    return types.SimpleNamespace(window=w, trace=trace, setup_s=12.5)


def _trace(**kw):
    args = dict(events=_events(), launches=[], frames=FRAMES, syncs=22, sync_sites={}, roofline={})
    args.update(kw)
    return Trace(**args)


def test_end_to_end_readers():
    assert reader("lane_frames_per_s")(_run()) == 20.0
    assert reader("setup_s")(_run()) == 12.5
    assert reader("frame_ms_p95")(_run(frame_ms=list(range(1, 101)))) == pytest.approx(95.05)
    assert reader("frame_ms_p95")(_run()) is None
    assert reader("peak_mem_gib")(_run(peak=3 * 2**30)) == 2.0
    assert reader("peak_mem_gib")(_run()) is None


@pytest.mark.parametrize("cells", ["eval", "live"])
def test_per_layer_readers(cells):
    run = _run(_trace())
    assert reader(f"host_syncs_per_frame.{cells}")(run) == 11.0
    # device ns per frame -> ms: front end 40, filter 100 + 20 + 60 (the copy launched in its range)
    assert reader(f"frontend_device_ms.{cells}")(run) == pytest.approx(40e-6)
    assert reader(f"filter_device_ms.{cells}")(run) == pytest.approx(180e-6)
    assert reader(f"schur_gating_device_ms.{cells}")(run) == pytest.approx(100e-6)
    # busy: [30, 70] + [250, 360] + [420, 440] a frame = 170 of 500 ns
    assert reader(f"device_idle_pct.{cells}")(run) == pytest.approx(100 * (1 - 340 / 1000))


def test_roofline_reader():
    counts = [Count(n_bytes=3_350_000, n_ops=0, device_ns=4000), Count(n_bytes=0, n_ops=67_000_000, device_ns=4000)]
    run = _run(_trace(roofline={"lk_corr_align": counts}))
    # each launch's bound is 1 us of its 4 us
    assert lk.bound_ms(3_350_000, 0)[0] == pytest.approx(1e-3)
    assert reader("lk_corr_align_roofline_pct")(run) == pytest.approx(25.0)
    assert reader("lk_corr_align_gain_roofline_pct")(run) is None


STAGED = ["frontend_device_ms", "filter_device_ms", "schur_gating_device_ms"]


@pytest.mark.parametrize("name", [f"{n}.{c}" for n in ["host_syncs_per_frame", "device_idle_pct", *STAGED]
                                  for c in ("eval", "live")]
                         + ["lk_corr_align_roofline_pct", "lk_corr_align_gain_roofline_pct"])
def test_absent(name):
    assert reader(name)(_run()) is None  # no trace
    no_device = [e for e in _events() if e.kind != "device"]
    gone = [e for e in _events() if e.name not in ("lost: Schur gating", "frontend total", "filter total")]
    assert reader(name)(_run(_trace(events=no_device, syncs=None))) is None
    if name.split(".")[0] in STAGED:
        assert reader(name)(_run(_trace(events=gone))) is None
