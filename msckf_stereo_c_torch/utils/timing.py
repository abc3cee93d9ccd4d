"""Per-phase timing harness (port of ``msckf_stereo_c_tpu/utils/timing.py``).

The reference wraps every back-end phase in std::chrono timers and prints a
red overrun report when a frame exceeds 1/frame_rate (msckf_vio.cpp:321-372).
Work on the card is queued, so a phase that should include the card's time
passes ``sync``: a tensor or device whose CUDA device is synchronised before
the phase's clock stops.  The report and the overrun count are the JAX
harness's.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def synchronize(sync) -> None:
    """Wait for the CUDA device of ``sync`` (a tensor, a device or a device
    name); nothing for a CPU one."""
    dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates wall-clock per named phase; reports overruns like the
    reference's featureCallback budget check."""

    def __init__(self, frame_budget_s: Optional[float] = None):
        self.frame_budget_s = frame_budget_s
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.overruns = 0

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def frame_done(self, frame_time_s: float):
        if self.frame_budget_s is not None and frame_time_s > self.frame_budget_s:
            self.overruns += 1

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            frac = t / total if total > 0 else 0.0
            n = self.counts[name]
            lines.append(
                f"{name:28s} {t:8.3f}s  {frac:6.1%}  ({t / max(n, 1) * 1e3:7.2f} ms/call x{n})"
            )
        if self.overruns:
            lines.append(f"frames over budget: {self.overruns}")
        return "\n".join(lines)
