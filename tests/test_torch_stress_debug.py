"""The port's stress diagnosis script (``msckf_stereo_c_torch/scripts/
stress_debug.py``) on the CPU over 0.3 s of the stress scene (7 frames)
with two temporal LK levels: the run, the error decomposition, the yaw
residuals and one table row per frame, all finite; with the exact-gravity
ablation and the dump, the filter's gravity is the simulator's during the
run and the patched initializer is restored after it."""
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.scripts import stress_debug
from msckf_stereo_c_torch.sim import stress as tstress

torch.set_num_threads(1)

BASE = {"STRESS_PLATFORM": "cpu", "STRESS_DURATION": "0.3", "STRESS_TLEVELS": "2"}


@pytest.mark.parametrize("extra", [{}, {"STRESS_EXACT_GRAVITY": "1"}], ids=["tlevels2", "exact_gravity"])
def test_stress_debug_runs_on_the_cpu(tmp_path, monkeypatch, capsys, extra):
    env = dict(BASE, **extra)
    seen = {}
    if extra:
        env["STRESS_DUMP"] = str(tmp_path / "dump.npz")
        run = tstress.run_vio_batch

        def spy(states, *args, **kwargs):
            seen["gravity"] = states.filt.gravity.clone()
            return run(states, *args, **kwargs)

        monkeypatch.setattr(tstress, "run_vio_batch", spy)
    init = tstress.batched_gravity_init
    out = stress_debug.main(env)
    assert tstress.batched_gravity_init is init
    printed = capsys.readouterr().out
    assert "klt=corr/tmpl1/tl2/sl1" in printed and " t[s]  err[m]  tex  occ  gain  tracks" in printed
    assert out["n_frames"] == 7 and len(out["buckets"]) == 7
    assert np.isfinite([out["ate_rmse"], out["ate_rigid"], *out["axis_rmse"], *out["yaw_deg"]]).all()
    assert all(np.isfinite(list(b.values())).all() for b in out["buckets"])
    assert out["min_tracks"] > 10
    if extra:
        np.testing.assert_array_equal(seen["gravity"].numpy(), np.float32([[0.0, 0.0, -9.81]]))
        with np.load(tmp_path / "dump.npz") as dump:
            assert dump["est"].shape == (7, 3) and dump["tracks"].shape == (7,)
