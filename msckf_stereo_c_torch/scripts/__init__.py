"""Command-line drivers of the port, run as ``python -m
msckf_stereo_c_torch.scripts.<name>``."""
