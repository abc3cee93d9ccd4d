"""Device-to-host reads of the frame step per batched frame: the program's
``host_read.*`` spans inside ``vio.step``; the cells that report
``lane_frames_per_s``."""
from bench_vio.trace.spans import host_reads_per_frame


def read(run):
    return host_reads_per_frame(run.trace)
