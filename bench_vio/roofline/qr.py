"""The least work of the textbook update's compressions
(``models/update.py:compress_measurements(method='qr')``, a thin QR of each
lane's stacked [H | r]) in a traced run, counted from what each call was
given.

While a profiler records, the program's ``ops/linalg.py:qr_r`` logs each
call's per-lane count of the rows and columns of [H | r] that hold a
nonzero entry (``qr_work_log``; the hand kernel counts them in its pass).
Zero rows (padding, unselected tracks) and zero columns (the IMU block,
empty camera slots) take no part in a QR, so a lane's least work is
Householder's on its nonzero (m, n) block: 2 p^2 (q - p / 3) operations
with p = min(m, n), q = max(m, n) (2mn^2 - 2n^3/3 where m >= n), and the
least bytes one read of the block and one write of R's p x n upper
trapezoid.  The count is the same whatever computes the QR; a program
that keeps no such log gives none.  Peaks as ``lk.py``'s: 3.35 TB/s and
67 TFLOP/s float32, one call's bound the larger of its two times."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .lk import bound_ms

SPAN = "filter.compress"


def lane_work(rows: np.ndarray, cols: np.ndarray, elem_bytes: int) -> tuple:
    """(bytes, operations) of QRs of nonzero blocks of ``rows`` x ``cols``
    (arrays, one entry a lane), summed."""
    m = np.asarray(rows, np.float64)
    n = np.asarray(cols, np.float64)
    p, q = np.minimum(m, n), np.maximum(m, n)
    n_ops = float((2.0 * p * p * (q - p / 3.0)).sum())
    n_bytes = float(((m * n + p * n - p * (p - 1) / 2) * elem_bytes).sum())
    return n_bytes, n_ops


def call_bound_ms(work: np.ndarray, elem_bytes: int) -> float:
    """Least time of one call whose lanes' (rows, columns) are ``work``
    (..., 2)."""
    w = np.asarray(work).reshape(-1, 2)
    return bound_ms(*lane_work(w[:, 0], w[:, 1], elem_bytes))[0]


def compress_roofline_pct(run) -> Optional[float]:
    """100 x (the traced compressions' least time) / (device time under
    the ``filter.compress`` spans).  One ``qr_r`` call a span, as under
    'qr': the run's calls are the program's ``qr_work_log``'s last
    entries, one a span (the reader runs right after its run).  None
    without a trace, such a span, device time under it, the log (a
    program that keeps none), or as many logged calls as spans."""
    from msckf_stereo_c_torch.ops import linalg

    from ..trace.spans import device_ms_under, spans

    t = run.trace
    if t is None:
        return None
    n_spans = len(spans(t.events, SPAN))
    per_frame_ms = device_ms_under(t, SPAN)
    log = list(getattr(linalg, "qr_work_log", ()))
    if not n_spans or not per_frame_ms or len(log) < n_spans:
        return None
    least_ms = sum(call_bound_ms(w.cpu().numpy(), elem) for w, elem in log[-n_spans:])
    return 100.0 * least_ms / (per_frame_ms * t.frames)
