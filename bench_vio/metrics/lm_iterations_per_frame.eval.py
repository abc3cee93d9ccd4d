"""LM iterations of the triangulation per batched frame: the program's
``host_read.lm_exit`` spans (one an iteration) under ``filter.lost`` and
``filter.camera_prune``; the cells that report ``lane_frames_per_s``."""
from bench_vio.trace.spans import lm_iterations_per_frame


def read(run):
    return lm_iterations_per_frame(run.trace)
