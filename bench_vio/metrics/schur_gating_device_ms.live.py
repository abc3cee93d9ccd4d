"""Device ms per batched frame inside the Schur gating's range
(``models/update.py:schur_gating``) within the lost-track update: the cells
that report ``frame_ms_p95``."""
from bench_vio.metrics import stage_ms


def read(run):
    return stage_ms(run, "lost: Schur gating")
