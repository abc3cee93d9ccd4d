"""One reader per metric: ``bench_vio/metrics/<name>.py`` defines
``read(run)``, which takes the run's records (``harness.Run``: the window,
the set-up time and, in a traced run, ``run.trace``) and returns the
metric's value, or None where the run holds nothing to read it from.  The
harness finds a reader by the metric's name in ``BENCHMARK.json``; a
metric whose reader returns None is left out of the result line."""
from __future__ import annotations

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_vio_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def stage_ms(run, label: str):
    """Device ms per batched frame inside the stage range ``label``; None
    without a trace or where no such range was recorded."""
    if run.trace is None:
        return None
    table = run.trace.stage_table
    row = table["stages"].get(label)
    if row is None or row["calls"] == 0 or table["device_ms"] <= 0:
        return None
    return row["device_ms"]


def roofline_pct(run, kernel: str):
    """The kernel's least time over its device time, in %, summed over the
    launches whose inputs the traced run kept; None without any."""
    if run.trace is None:
        return None
    counts = run.trace.roofline.get(kernel) or []
    device_ms = sum(c.device_ns for c in counts) / 1e6
    if not counts or device_ms <= 0:
        return None
    return 100.0 * sum(c.bound_ms for c in counts) / device_ms


def syncs_per_frame(run):
    """Host-device synchronisations inside the port per profiled batched
    frame (torch's sync debug mode); None without a count."""
    t = run.trace
    return None if t is None or t.syncs is None else t.syncs / t.frames


def idle_pct(run):
    """The share of the traced window in which no kernel, copy or set runs
    on the card (the union of the device intervals), in %."""
    from bench_vio.trace.events import busy_ns

    t = run.trace
    if t is None or t.span is None:
        return None
    lo, hi = t.span
    busy = busy_ns(t.events, lo, hi)
    if busy <= 0 or hi <= lo:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
