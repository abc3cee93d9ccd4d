"""Image and small-matrix operators; ``patch_extract`` and ``klt_corr`` hold
the CUDA kernels' wrappers and their plain versions."""
