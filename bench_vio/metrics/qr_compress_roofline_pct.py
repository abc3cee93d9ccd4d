"""The compressions' least time over their device time, in %: each
``filter.compress`` span of the traced frames is one thin QR of every
lane's stacked [H | r], whose least work ``roofline/qr.py`` counts from
the nonzero rows and columns the program logged for that call, whatever
computes it."""
from bench_vio.roofline.qr import compress_roofline_pct


def read(run):
    return compress_roofline_pct(run)
