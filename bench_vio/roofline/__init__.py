"""The kernels' least work: the frozen count of ``chip_smoke.py`` (``lk``)
and the capture and replay of a traced run's LK launches (``capture``)."""
