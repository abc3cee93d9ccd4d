"""The front end's paths off the bench configuration, one ``frontend_step``
at a time against the JAX package's (set-up and tolerances in
tests/_torch_frontend_scene.py): multi-level temporal LK, two stereo
levels, the rotation-only prediction (``cam_vel`` None), pyramids of one and
two levels, and the affine-photometric norm over two temporal levels.
The unfused stereo calls are in tests/test_torch_frontend_unfused.py.

The rotation-only warp alone against JAX's homography product and a float64
one, on every pixel of a 16-px grid: within 2e-3 px in float32, and no
matmul (the same result with TF32 allowed).

Then B=2 distinct lanes (two stretches of the trajectory) under
``temporal_levels=2`` with RANSAC, in float64, against their one-lane runs:
ids exact, every float within 1e-9.  On these clean frames RANSAC keeps
every match; tests/test_torch_ransac.py holds its rejections."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import msckf_stereo_c_tpu.ops.klt_corr as jkc
from _torch_frontend_scene import CALIB, frame_inputs, jax_params, make_scene, run_both
from msckf_stereo_c_torch.config import matmul_precision_scope
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.models import frontend as tfe
from msckf_stereo_c_torch.utils.lanes import lane, stack_lanes
from msckf_stereo_c_torch.utils.lie import so3_exp

torch.set_num_threads(1)

OPTIONS = {
    "temporal_levels_2": dict(temporal_levels=2),
    "temporal_levels_4": dict(temporal_levels=4),
    "stereo_levels_2": dict(stereo_levels=2),
    "rotation_only": dict(),
    "pyramid_levels_1": dict(pyramid_levels=1),
    "pyramid_levels_2": dict(pyramid_levels=2),
    "gain_temporal_levels_2": dict(temporal_levels=2, klt_norm="gain"),
}
LANE_IDX = (np.array([290, 300, 310]), np.array([500, 510, 520]))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.mark.parametrize("name", list(OPTIONS))
def test_frontend_step_matches_jax(scene, monkeypatch, name):
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    outs = run_both(OPTIONS[name], scene, cam_vel=name != "rotation_only")
    assert int(outs[-1].after_ransac) > 15


def test_lanes_equal_one_lane_runs_f64():
    """Two lanes with their own images and IMU, stepped together, equal
    each lane stepped alone (float64, RANSAC on both cameras)."""
    cfg = tconfig.FrontendConfig(max_features=48, temporal_levels=2, ransac_enabled=True)
    f64 = torch.float64
    params = tfe.make_frontend_params(CALIB, f64)
    scenes = [make_scene(idx) for idx in LANE_IDX]
    alone = []
    for (traj, imu, img0, img1), idx in zip(scenes, LANE_IDX):
        state, pyr_prev, outs = tfe.init_tracker_state(cfg, f64), None, []
        for k in range(3):
            p0 = tfe.pyramids_for(torch.as_tensor(img0[k], dtype=f64), cfg)
            p1 = tfe.pyramids_for(torch.as_tensor(img1[k], dtype=f64), cfg)
            pyr_prev = pyr_prev or tuple(torch.zeros_like(x) for x in p0)
            g, dt, first, v = (torch.as_tensor(np.asarray(x)) for x in frame_inputs(traj, imu, idx, k))
            state, out = tfe.frontend_step(state, pyr_prev, p0, p1, g.to(f64), dt.to(f64), first, params, cfg,
                                           v.to(f64))
            outs.append((state, out))
            pyr_prev = p0
        alone.append(outs)

    state = stack_lanes([tfe.init_tracker_state(cfg, f64)] * 2)
    pyr_prev = None
    for k in range(3):
        p0 = tfe.pyramids_for(torch.stack([torch.as_tensor(s[2][k], dtype=f64) for s in scenes]), cfg)
        p1 = tfe.pyramids_for(torch.stack([torch.as_tensor(s[3][k], dtype=f64) for s in scenes]), cfg)
        pyr_prev = pyr_prev or tuple(torch.zeros_like(x) for x in p0)
        ins = [frame_inputs(s[0], s[1], idx, k) for s, idx in zip(scenes, LANE_IDX)]
        g, dt, first, v = (torch.as_tensor(np.stack(x)) for x in zip(*ins))
        state, out = tfe.batched_frontend_step(state, pyr_prev, p0, p1, g.to(f64), dt.to(f64), first, params, cfg,
                                               v.to(f64))
        pyr_prev = p0
        for b in range(2):
            want_state, want_out = alone[b][k]
            for got, want in zip(list(lane(state, b)) + list(lane(out, b)), list(want_state) + list(want_out)):
                if got.dtype.is_floating_point:
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9)
                else:
                    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_rotation_warp_matches_jax():
    """The port's elementwise homography K R K^-1 against JAX's matmul
    form (``frontend.py:584-598``) and a float64 reference, at 0.05 s of a
    fast turn."""
    K = np.asarray(jax_params().K0, np.float64)
    R = so3_exp(torch.tensor([[0.3, -0.8, 0.5]], dtype=torch.float64) * 0.05).transpose(-1, -2)
    gy, gx = np.mgrid[0:480:16, 0:752:16]
    pts = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64) + 0.37

    def warp64():
        Km = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
        w = np.concatenate([pts, np.ones_like(pts[:, :1])], 1) @ (Km @ R[0].numpy() @ np.linalg.inv(Km)).T
        return w[:, :2] / w[:, 2:]

    fx, fy, cx, cy = (jnp.float32(k) for k in K)
    Km = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)
    Kinv = jnp.array([[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy], [0, 0, 1]], jnp.float32)
    ph = jnp.concatenate([jnp.asarray(pts, jnp.float32), jnp.ones((len(pts), 1), jnp.float32)], 1)
    w = ph @ (Km @ jnp.asarray(R[0].numpy(), jnp.float32) @ Kinv).T
    want = np.asarray(w[:, :2] / w[:, 2:3])
    args = (torch.as_tensor(pts, dtype=torch.float32)[None], torch.as_tensor(K, dtype=torch.float32), R.float())
    got = tfe._rotation_warp(*args)[0].numpy()
    with matmul_precision_scope("default"):
        assert np.array_equal(tfe._rotation_warp(*args)[0].numpy(), got)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got, warp64(), rtol=0, atol=2e-3)
    assert np.abs(warp64() - pts).max() > 5.0  # the turn moves the points
