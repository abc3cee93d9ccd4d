"""The LM steps of the triangulation in a traced run, counted by the
program itself.

While a profiler records, the program's ``models/triangulation.py:
triangulate_tracks`` logs each call's per-track LM steps
(``lm_work_log``: an int32 (B, K) tensor a call; on the card the hand kernel
``lm_triangulate`` counts them, on the CPU the plain loop).  The frame step
opens one ``filter.triangulate`` span around each call, so the run's calls
are the log's last entries, one a span (the reader runs right after its
run).  A call's largest count is the number of iterations the masked loop
that runs all tracks together makes (and reads its exit for), so the
per-frame sum reads the same work as ``lm_iterations_per_frame`` does on a
program with that loop.  A program that keeps no such log gives none."""
from __future__ import annotations

from typing import Optional

from .spans import spans

SPAN = "filter.triangulate"


def lm_kernel_iterations_per_frame(run) -> Optional[float]:
    """Per traced frame, the sum over the ``filter.triangulate`` spans of
    that call's largest per-track LM steps.  None without a trace, such a
    span, the log, or as many logged calls as spans."""
    from msckf_stereo_c_torch.models import triangulation

    t = run.trace
    if t is None:
        return None
    n_spans = len(spans(t.events, SPAN))
    log = list(getattr(triangulation, "lm_work_log", ()))
    if not n_spans or len(log) < n_spans:
        return None
    return sum(int(steps.max()) if steps.numel() else 0 for steps in log[-n_spans:]) / t.frames
