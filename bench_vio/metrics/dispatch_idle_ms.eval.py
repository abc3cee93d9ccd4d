"""Device-idle ms per batched frame inside the program's ``vio.step`` spans
and outside its ``host_read.*`` spans: the card waiting for the host's
dispatch within the step; the cells that report ``lane_frames_per_s``."""
from bench_vio.trace.spans import dispatch_idle_ms


def read(run):
    return dispatch_idle_ms(run.trace)
