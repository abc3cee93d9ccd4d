"""The benchmark's traffic generator: frozen copies of the port's scene
modules (``sim/trajectory.py``, ``sim/render.py``, ``sim/render_torch.py``
of ``msckf_stereo_c_torch`` at commit 50013dad8c92), and ``make_cell_inputs``
(``generate.py``), which builds a cell's scenes, IMU streams and seeds from
its configuration and traffic files."""
