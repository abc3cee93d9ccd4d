"""The port's dataset entry points: ``python -m msckf_stereo_c_torch.apps.run_euroc``
and ``python -m msckf_stereo_c_torch.apps.run_euroc_batch``."""
