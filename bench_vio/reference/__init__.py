"""The benchmark's plain reference: a frozen copy of the port's model code
(``config.py``, ``io/``, ``models/``, ``ops/``, ``utils/`` of
``msckf_stereo_c_torch`` at commit 50013dad8c92), in which every hand
kernel's wrapper takes its plain PyTorch version on the CPU and on the card
alike.  Each file names the file it was copied from.  It imports nothing of
the port, of JAX or of the JAX package, and later changes to the port do
not reach it: it is the yardstick ``bench_vio/judge.py`` holds the
program's outputs against."""
