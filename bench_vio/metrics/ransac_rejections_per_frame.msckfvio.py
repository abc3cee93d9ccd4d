"""Matches the two-point RANSAC rejected per batched frame, summed over the
lanes and both cameras, as the program counts them (``ransac_work_log``):
the msckf_vio-tracker cell.  An engagement counter: a change that moves it
changed what the RANSAC decides."""
from bench_vio.trace.ransac_work import ransac_rejections_per_frame


def read(run):
    return ransac_rejections_per_frame(run)
