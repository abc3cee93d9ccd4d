"""The small helpers the port carries beside its modules, each against the
JAX package's function on seeded numpy inputs in float64 (within 1e-12,
booleans and counts exact), and the visualization copy (``io/viz.py``):
``draw_feature_tracks`` writes the same image as JAX's, ``plot_trajectory``
writes a PNG."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_torch.models as tmodels
import msckf_stereo_c_torch.utils as tutils
from msckf_stereo_c_torch.io import viz as tviz
from msckf_stereo_c_torch.models import state as tstate
from msckf_stereo_c_torch.models.triangulation import check_motion
from msckf_stereo_c_torch.ops import camera as tcamera
from msckf_stereo_c_tpu.io import viz as jviz
from msckf_stereo_c_tpu.models import state as jstate
from msckf_stereo_c_tpu.models import triangulation as jtri
from msckf_stereo_c_tpu.ops import camera as jcamera
from msckf_stereo_c_tpu.utils import lie as jlie
from msckf_stereo_c_tpu.utils import quaternion as jquat

TOL = 1e-12
RNG = np.random.default_rng(2024)


def _rotations(n):
    return np.asarray(jlie.so3_exp(jnp.asarray(RNG.normal(0, 1.0, (n, 3)))))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def test_se3_inverse_and_compose():
    Ra, Rb = _rotations(5), _rotations(5)
    ta, tb = RNG.normal(size=(5, 3)), RNG.normal(size=(5, 3))
    for got, want in zip(tutils.se3_inverse(torch.tensor(Ra), torch.tensor(ta)),
                         jlie.se3_inverse(jnp.asarray(Ra), jnp.asarray(ta))):
        _close(got, want)
    T = [torch.tensor(x) for x in (Ra, ta, Rb, tb)]
    for got, want in zip(tutils.se3_compose(*T), jlie.se3_compose(*(jnp.asarray(x) for x in (Ra, ta, Rb, tb)))):
        _close(got, want)


def test_jpl_to_hamilton_and_quat_rotate():
    q = np.asarray(jquat.rot_to_jpl(jnp.asarray(_rotations(6))))
    v = RNG.normal(size=(6, 3))
    _close(tutils.jpl_to_hamilton(torch.tensor(q)), jquat.jpl_to_hamilton(jnp.asarray(q)))
    _close(tutils.quat_rotate(torch.tensor(q), torch.tensor(v)), jquat.quat_rotate(jnp.asarray(q), jnp.asarray(v)))


def test_project_to_stereo_normalized():
    p = RNG.normal(size=(7, 3)) + np.array([0.0, 0.0, 4.0])
    R, t = _rotations(1)[0], RNG.normal(0, 0.1, 3)
    got = tcamera.project_to_stereo_normalized(torch.tensor(p), torch.tensor(R), torch.tensor(t))
    want = jcamera.project_to_stereo_normalized(jnp.asarray(p), jnp.asarray(R), jnp.asarray(t))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n", [0, 3, 6])
def test_active_masks(n):
    M, D = 6, 21 + 6 * 6
    np.testing.assert_array_equal(tstate.active_cam_mask(torch.tensor(n), M).numpy(),
                                  np.asarray(jstate.active_cam_mask(jnp.asarray(n), M)))
    np.testing.assert_array_equal(tstate.active_state_mask(torch.tensor(n), D).numpy(),
                                  np.asarray(jstate.active_state_mask(jnp.asarray(n), D)))


def _track(seed):
    """A landmark seen from a window of 5 cameras walking along x, 4
    valid observations, stereo-normalized (R_c0_c1 = I, t = -0.11 x)."""
    rng = np.random.default_rng(seed)
    M = 5
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.05, (M, 3)))))
    q = np.asarray(jquat.rot_to_jpl(jnp.asarray(R)))
    p = np.stack([0.1 * np.arange(M), rng.normal(0, 0.02, M), np.zeros(M)], 1)
    lm = np.array([0.3, -0.2, 3.0]) + rng.normal(0, 0.2, 3)
    R01, t01 = np.eye(3), np.array([-0.11, 0.0, 0.0])
    pc0 = np.einsum("mij,mj->mi", R, lm - p)
    pc1 = pc0 @ R01.T + t01
    obs = np.concatenate([pc0[:, :2] / pc0[:, 2:], pc1[:, :2] / pc1[:, 2:]], 1) + rng.normal(0, 1e-3, (M, 4))
    valid = np.array([False, True, True, True, True])
    return obs, valid, q, p, R01, t01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_track_and_check_motion(seed):
    """The one-track views against JAX's one-track functions (the LM loop
    converges to its tolerance on both sides; positions within 1e-9 m)."""
    obs, valid, q, p, R01, t01 = _track(seed)
    got = tmodels.triangulate_track(*(torch.tensor(x) for x in (obs, valid, q, p, R01, t01)))
    want = jtri.triangulate_track(*(jnp.asarray(x) for x in (obs, valid, q, p, R01, t01)))
    np.testing.assert_allclose(got.pos_w.numpy(), np.asarray(want.pos_w), rtol=0, atol=1e-9)
    assert bool(got.valid) == bool(want.valid) and int(got.base_slot) == int(want.base_slot) == 1
    for thr in (-1.0, 0.05, 0.5):
        assert bool(check_motion(torch.tensor(obs), torch.tensor(valid), torch.tensor(q), torch.tensor(p), thr)) == \
            bool(jtri.check_motion(jnp.asarray(obs), jnp.asarray(valid), jnp.asarray(q), jnp.asarray(p), thr))


def test_draw_feature_tracks_matches_jax(tmp_path):
    import cv2

    H, W, N = 48, 80, 12
    img0 = RNG.uniform(0, 255, (H, W))
    img1 = RNG.uniform(0, 255, (H, W))
    pts0 = RNG.uniform(4, [W - 4, H - 4], (N, 2))
    pts1 = pts0 - [RNG.uniform(1, 6), 0.0]
    valid = RNG.uniform(size=N) < 0.7
    tviz.draw_feature_tracks(str(tmp_path / "port.png"), img0, img1, pts0, pts1, valid)
    jviz.draw_feature_tracks(str(tmp_path / "jax.png"), img0, img1, pts0, pts1, valid)
    got, want = cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "jax.png"))
    assert got.shape == (H, 2 * W, 3)
    np.testing.assert_array_equal(got, want)


def test_plot_trajectory_writes_png(tmp_path):
    t = np.linspace(0, 2 * np.pi, 50)
    est = np.stack([np.cos(t), np.sin(t), 0.1 * t], 1)
    path = tmp_path / "traj.png"
    tviz.plot_trajectory(str(path), est, gt_p=est + 0.01, landmarks=RNG.normal(size=(30, 3)))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert path.stat().st_size > 1000
