# Frozen copy of msckf_stereo_c_torch/ops/__init__.py at commit 50013dad8c92.
"""Image and small-matrix operators; ``patch_extract`` and ``klt_corr`` hold
the CUDA kernels' wrappers and their plain versions."""
