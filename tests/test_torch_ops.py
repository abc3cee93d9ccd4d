"""The port's image and small-matrix operators against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both.  Tolerances:
float64 paths agree to 1e-10 relative (the same formulas, other summation
order); float32 paths to 1e-5; the pyramid and presmooth to 1e-3 grey
levels (the JAX package applies each 1-D pass as a banded GEMM, the port as
five shifted adds); FAST gives the identical corner set with scores within
1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.ops import camera as tcam
from msckf_stereo_c_torch.ops import fast as tfast
from msckf_stereo_c_torch.ops import linalg as tlin
from msckf_stereo_c_torch.ops import pyramid as tpyr
from msckf_stereo_c_torch.utils import chi2 as tchi2
from msckf_stereo_c_torch.utils import lie as tlie
from msckf_stereo_c_torch.utils import quaternion as tquat
from msckf_stereo_c_tpu.config import EUROC_CALIB
from msckf_stereo_c_tpu.ops import camera as jcam
from msckf_stereo_c_tpu.ops import fast as jfast
from msckf_stereo_c_tpu.ops import linalg as jlin
from msckf_stereo_c_tpu.ops import pyramid as jpyr
from msckf_stereo_c_tpu.utils import chi2 as jchi2
from msckf_stereo_c_tpu.utils import lie as jlie
from msckf_stereo_c_tpu.utils import quaternion as jquat

torch.set_num_threads(1)

_RTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=_RTOL[dtype] * scale)


def _spd(rng, n, batch, lo=1.0, hi=10.0):
    Q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    lam = rng.uniform(lo, hi, (batch, n))
    return np.einsum("bij,bj,bkj->bik", Q, lam, Q)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_linalg(dtype):
    rng = np.random.default_rng(0)
    A2 = (_spd(rng, 2, 16)).astype(dtype)
    b2 = rng.normal(size=(16, 2)).astype(dtype)
    A3 = (_spd(rng, 3, 16) + 0.3 * rng.normal(size=(16, 3, 3))).astype(dtype)
    b3 = rng.normal(size=(16, 3)).astype(dtype)
    M = _spd(rng, 12, 4).astype(dtype)
    t = torch.as_tensor
    _close(tlin.solve2x2(t(A2), t(b2)), jlin.solve2x2(jnp.asarray(A2), jnp.asarray(b2)), dtype)
    _close(tlin.solve3x3(t(A3), t(b3)), jlin.solve3x3(jnp.asarray(A3), jnp.asarray(b3)), dtype)
    _close(tlin.inv3x3(t(A3)), jlin.inv3x3(jnp.asarray(A3)), dtype)
    got = tlin.ns_posdef_inverse(t(M), 1.0, iters=10)
    _close(got, jlin.ns_posdef_inverse(jnp.asarray(M), 1.0, iters=10), dtype)
    assert got.dtype == t(M).dtype


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_camera(model):
    rng = np.random.default_rng(1)
    K = np.asarray(EUROC_CALIB.cam0.intrinsics)
    D = (
        np.asarray(EUROC_CALIB.cam0.distortion_coeffs)
        if model == "radtan"
        else np.array([-0.01, 0.003, -0.001, 0.0002])
    )
    R = np.asarray(EUROC_CALIB.T_cam0_cam1_mat()[:3, :3])
    pts = np.stack([rng.uniform(20, 732, 64), rng.uniform(20, 460, 64)], 1)
    xn = rng.uniform(-0.6, 0.6, (64, 2))
    for dtype in (np.float64, np.float32):
        t = [torch.as_tensor(a.astype(dtype)) for a in (pts, K, D, R, xn)]
        j = [jnp.asarray(a.astype(dtype)) for a in (pts, K, D, R, xn)]
        _close(
            tcam.undistort_points(t[0], t[1], t[2], model=model, R=t[3]),
            jcam.undistort_points(j[0], j[1], j[2], model=model, R=j[3]),
            dtype,
        )
        _close(
            tcam.undistort_points(t[0], t[1], t[2], model=model),
            jcam.undistort_points(j[0], j[1], j[2], model=model),
            dtype,
        )
        _close(
            tcam.distort_points(t[4], t[1], t[2], model=model),
            jcam.distort_points(j[4], j[1], j[2], model=model),
            dtype,
        )


def test_lie_and_quaternion():
    rng = np.random.default_rng(2)
    phi = np.concatenate([rng.normal(size=(20, 3)) * 0.7, rng.normal(size=(4, 3)) * 1e-9])
    q = rng.normal(size=(24, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(24, 4))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    a, b = rng.normal(size=(24, 3)), rng.normal(size=(24, 3))
    t, j = torch.as_tensor, jnp.asarray
    f64 = np.float64
    _close(tlie.skew(t(phi)), jlie.skew(j(phi)), f64)
    _close(tlie.so3_exp(t(phi)), jlie.so3_exp(j(phi)), f64)
    R = np.array(jlie.so3_exp(j(phi)))
    _close(tlie.rotation_angle(t(R)), jlie.rotation_angle(j(R)), f64)
    _close(tlie.rot_from_two_vectors(t(a), t(b)), jlie.rot_from_two_vectors(j(a), j(b)), f64)
    _close(tquat.quat_normalize(t(2.0 * q)), jquat.quat_normalize(j(2.0 * q)), f64)
    _close(tquat.jpl_to_rot(t(q)), jquat.jpl_to_rot(j(q)), f64)
    # rot_to_jpl is sign-ambiguous only where the JAX branch choice is; both
    # take the same branch on the same input.
    _close(tquat.rot_to_jpl(t(R)), jquat.rot_to_jpl(j(R)), f64)
    _close(tquat.quat_multiply(t(q), t(p)), jquat.quat_multiply(j(q), j(p)), f64)
    _close(tquat.small_angle_quaternion(t(phi)), jquat.small_angle_quaternion(j(phi)), f64)
    _close(tquat.quat_identity(), jquat.quat_identity(), f64)
    np.testing.assert_array_equal(tchi2.chi2_p95_table(99), jchi2.chi2_p95_table(99))


def _image(seed, H, W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1))
    img = np.kron(img, np.ones((4, 4)))[:H, :W] + rng.normal(0, 4, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape", [(120, 188), (61, 95)])
def test_pyramid_and_smooth(shape):
    img = _image(3, *shape)
    got = tpyr.build_pyramid(torch.as_tensor(img), 4)
    want = jpyr.build_pyramid(jnp.asarray(img), 4)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        tpyr.smooth5(torch.as_tensor(img)).numpy(), np.asarray(jpyr.smooth5(jnp.asarray(img))),
        rtol=0, atol=1e-3,
    )


def test_fast():
    img = _image(4, 96, 128)
    thr = 7.0
    got = tfast.fast_score_map(torch.as_tensor(img), thr).numpy()
    want = np.asarray(jfast.fast_score_map(jnp.asarray(img), thr))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want > 0).sum() > 50

    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 128, (20, 2)).astype(np.float32)
    valid = rng.uniform(size=20) < 0.7
    occ_t = tfast.occupancy_from_points(torch.as_tensor(pts), torch.as_tensor(valid), (96, 128), 16)
    occ_j = jfast.occupancy_from_points(jnp.asarray(pts), jnp.asarray(valid), (96, 128), 16)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))

    ct = tfast.detect_grid_corners(torch.as_tensor(img), thr, 16, occ_t)
    cj = jfast.detect_grid_corners(jnp.asarray(img), thr, 16, occ_j)
    np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
    np.testing.assert_array_equal(ct.xy.numpy(), np.asarray(cj.xy))
    np.testing.assert_allclose(ct.score.numpy(), np.asarray(cj.score), rtol=0, atol=1e-4)
