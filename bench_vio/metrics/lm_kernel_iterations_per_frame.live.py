"""LM steps of the triangulation per batched frame, as the program counts
them: each ``filter.triangulate`` call's largest per-track count
(``lm_work_log``), summed over the frame's calls; the cells that report
``frame_ms_p95``."""
from bench_vio.trace.lm_work import lm_kernel_iterations_per_frame


def read(run):
    return lm_kernel_iterations_per_frame(run)
