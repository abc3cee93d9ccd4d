"""The port's VIO -> keyframe BA glue (``msckf_stereo_c_torch/parallel/refine.py``)
and the stress script's refinement tier, in float64 on the CPU.

One JAX ``run_sequence`` of tests/test_refine.py's scene (8 s circle, 300
landmarks, projected tracks) gives the numpy outputs both packages'
``build_ba_problem`` take: obs and mask equal exactly, landmarks and camera
poses within 1e-12; ``refine_trajectory`` costs rtol 1e-9, poses and
landmarks within 1e-9; ``problem_to_body_poses`` within 1e-12.  The
script's ``STRESS_REFINE=1`` tier runs on a short stress run and prints the
JAX script's keys."""
import json

import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.parallel import refine as tref
from msckf_stereo_c_torch.scripts import stress_gate as tgate
from msckf_stereo_c_tpu.config import EUROC_CALIB, FilterConfig
from msckf_stereo_c_tpu.models import run_sequence
from msckf_stereo_c_tpu.parallel import refine as jref
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_landmarks, project_tracks, synthesize_imu

CFG = FilterConfig(max_cam_state_size=8, max_tracks=48, max_imu_per_frame=12)


@pytest.fixture(scope="module")
def vio_run():
    """tests/test_refine.py's VIO run: (times, quats, positions, fid, uv,
    valid) as numpy arrays."""
    traj = make_circle_trajectory(duration=8.0)
    imu = synthesize_imu(traj, gyro_noise=5e-4, acc_noise=5e-3, seed=0)
    feats = project_tracks(traj, make_landmarks(num=300), max_features=32, pixel_noise=0.2)
    res = run_sequence(CFG, EUROC_CALIB, feats.t, feats.fid, feats.uv, feats.valid,
                       imu.t, imu.gyro, imu.acc, method="schur")
    return tuple(np.asarray(x) for x in (res.times, res.quats_xyzw, res.positions, feats.fid, feats.uv, feats.valid))


@pytest.mark.parametrize("stride,max_kf", [(8, 16), (5, 40)])
def test_build_ba_problem_matches_jax(vio_run, stride, max_kf):
    want = jref.build_ba_problem(*vio_run, keyframe_stride=stride, max_keyframes=max_kf)
    got = tref.build_ba_problem(*vio_run, keyframe_stride=stride, max_keyframes=max_kf, device="cpu")
    assert got.mask.shape[1] >= 8 and got.mask.shape[0] >= 8
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
    for field in ("landmarks", "cam_p", "cam_q", "R_c0_c1", "t_c0_c1"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)
    # The batched rot_to_jpl gives JAX's per-matrix quaternions, signs too.
    assert (got.cam_q[:, 3] >= 0).all()


def test_refine_trajectory_matches_jax(vio_run):
    jp = jref.build_ba_problem(*vio_run, keyframe_stride=8, max_keyframes=16)
    tp = tref.build_ba_problem(*vio_run, keyframe_stride=8, max_keyframes=16, device="cpu")
    want, wc = jref.refine_trajectory(jp, iters=8)
    got, gc = tref.refine_trajectory(tp, iters=8)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-9, atol=1e-20)
    assert float(gc[-1]) < float(gc[0])
    for field in ("cam_q", "cam_p", "landmarks"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tref.problem_to_body_poses(got), jref.problem_to_body_poses(want), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tref.problem_to_body_poses(tp), jref.problem_to_body_poses(jp), rtol=0, atol=1e-12)


def test_too_few_tracks_gives_none(vio_run):
    times, q, p, fid, uv, valid = vio_run
    assert tref.build_ba_problem(times[:10], q[:10], p[:10], fid[:10], uv[:10], valid[:10],
                                 keyframe_stride=5, device="cpu") is None
    assert jref.build_ba_problem(times[:10], q[:10], p[:10], fid[:10], uv[:10], valid[:10],
                                 keyframe_stride=5) is None


def test_stress_refine_tier(capsys):
    """STRESS_REFINE=1 on the CPU: 0.6 s of the stress scene (13 frames),
    keyframes every 2 frames; the last line carries the JAX script's refine
    keys, the cost falls and the keyframe ATE stays under the gate."""
    env = dict(STRESS_PLATFORM="cpu", STRESS_DURATION="0.6", STRESS_REFINE="1", STRESS_REFINE_STRIDE="2",
               STRESS_METHOD="qr", STRESS_NS_ITERS="0")
    line = tgate.main(env, argv=[])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert {"refine_keyframes", "refine_landmarks", "refine_cost_drop", "ate_kf_before", "ate_kf_after"} <= set(line)
    assert line["refine_keyframes"] == 7 and line["refine_landmarks"] >= 8
    assert line["refine_cost_drop"] > 1.0
    assert np.isfinite(line["ate_kf_after"]) and line["ate_kf_after"] < 0.13
