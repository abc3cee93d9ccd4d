"""The matches the two-point RANSAC rejected in a traced run, counted by
the program itself.

While a profiler records, the program's ``ops/ransac.py:two_point_ransac``
logs each call's rejected matches a lane (``ransac_work_log``: an int32
(B,) tensor a call, ``valid & ~mask`` summed on the device).  The frame
step opens one ``frontend.ransac`` span around its two calls (cam0, cam1),
so the run's calls are the log's last entries, two a span (the reader runs
right after its run).  A program that keeps no such log, or opens no such
span, gives none."""
from __future__ import annotations

from typing import Optional

from .spans import spans

SPAN = "frontend.ransac"
CALLS_PER_SPAN = 2  # one a camera


def ransac_rejections_per_frame(run) -> Optional[float]:
    """Per traced frame, the matches rejected over every lane and both
    cameras.  None without a trace, such a span, the log, or as many logged
    calls as the spans hold."""
    from msckf_stereo_c_torch.ops import ransac

    t = run.trace
    if t is None:
        return None
    n_calls = CALLS_PER_SPAN * len(spans(t.events, SPAN))
    log = list(getattr(ransac, "ransac_work_log", ()))
    if not n_calls or len(log) < n_calls:
        return None
    return sum(int(rejected.sum()) for rejected in log[-n_calls:]) / t.frames
