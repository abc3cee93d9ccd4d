"""The frozen scene generator equals the port's ``sim/`` at the commit it
was frozen from, on a 2-frame render on the CPU."""
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.config import EUROC_CALIB
from msckf_stereo_c_torch.sim import render_torch as port_render
from msckf_stereo_c_torch.sim import trajectory as port_traj
from msckf_stereo_c_torch.sim.stress import protocol_lm_seed as port_lm_seed

from bench_vio.reference.config import EUROC_CALIB as FROZEN_CALIB
from bench_vio.scene import generate
from bench_vio.scene import render_torch as frozen_render
from bench_vio.scene import trajectory as frozen_traj


def test_trajectory_landmarks_imu_equal():
    a = port_traj.make_stress_trajectory(duration=3.0)
    b = frozen_traj.make_stress_trajectory(duration=3.0)
    for f in ("t", "p", "v", "acc", "gyro", "R_w_b"):
        if hasattr(a, f):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(port_traj.make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1005),
                          frozen_traj.make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1005))
    ia = port_traj.synthesize_imu(a, gyro_noise=5e-4, acc_noise=5e-3, seed=2**31 + 3)
    ib = frozen_traj.synthesize_imu(b, gyro_noise=5e-4, acc_noise=5e-3, seed=2**31 + 3)
    assert np.array_equal(ia.gyro, ib.gyro) and np.array_equal(ia.acc, ib.acc)
    for s in (0, 1, 2**31 + 7):
        assert generate.protocol_lm_seed(s) == port_lm_seed(s)


@pytest.mark.parametrize("stress", [False, True])
def test_two_frame_render_equal(stress):
    traj = port_traj.make_stress_trajectory(duration=3.0)
    idx = np.array([20, 30])
    lm = port_traj.make_room_landmarks(num=900, radius=7.0, z_cap=3.5, seed=1001)
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU renderer's reductions are bit-exact on one thread only
    try:
        out = _render_both(traj, idx, lm, stress)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def _render_both(traj, idx, lm, stress):
    out = []
    for mod, calib in ((port_render, EUROC_CALIB), (frozen_render, FROZEN_CALIB)):
        ev = (mod.make_stress_events(traj, np.arange(0, 61, 10), noise_seed=2**31 + 1).slice(2, 4) if stress
              else mod.StressEvents.nominal(2))
        r = mod.TorchRenderer(lm, calib, r_wall=7.0, z_cap=3.5, device="cpu")
        out.append(r.render_sequence(traj, idx, ev, chunk=64))
    return out

