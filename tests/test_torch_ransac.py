"""Two-point RANSAC (``ops/ransac.py``) against the JAX package's, on
tests/test_ransac.py's three cases (planted outliers under a pure
translation, a static camera, too few points), with the JAX function's
``jax.random`` draws passed in: the inlier masks exact.  Then lanes against
one-lane calls (exact), and the port's own draws: in range, different for
each ``next_fid`` and camera, and made without a host read."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from msckf_stereo_c_torch.ops import camera as tcamera
from msckf_stereo_c_torch.ops.ransac import NUM_HYPOTHESES, ransac_draws, two_point_ransac
from msckf_stereo_c_tpu.config import EUROC_CALIB
from msckf_stereo_c_tpu.ops.ransac import two_point_ransac as jax_ransac

torch.set_num_threads(1)

K = np.asarray(EUROC_CALIB.cam0.intrinsics, np.float32)
D = np.asarray(EUROC_CALIB.cam0.distortion_coeffs, np.float32)


def _project(p_cam):
    uv = torch.as_tensor(p_cam[:, :2] / p_cam[:, 2:], dtype=torch.float64)
    return tcamera.distort_points(uv, torch.as_tensor(K, dtype=torch.float64),
                                  torch.as_tensor(D, dtype=torch.float64)).numpy()


def _translation_pair(rng, n=60, n_out=8, t=np.array([0.1, 0.02, 0.05])):
    pts_w = rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0, 0, 4.0])
    uv1, uv2 = _project(pts_w), _project(pts_w - t[None])
    out = rng.choice(n, n_out, replace=False)
    uv2[out] += rng.uniform(8, 25, (n_out, 2)) * np.sign(rng.normal(size=(n_out, 2)))
    return uv1, uv2, out


def _static_pair(rng, n=40):
    uv = _project(rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0, 0, 4.0]))
    uv2 = uv + rng.normal(0, 0.05, uv.shape)
    uv2[:5] += 300.0  # beyond the 50*norm_pixel_unit prefilter
    return uv, uv2


def _jax_draws(key):
    """The raw draws JAX's ``two_point_ransac`` makes from ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(np.array(jax.random.randint(k, (NUM_HYPOTHESES,), 0, 1 << 30)) for k in (k1, k2))


def _both(uv1, uv2, seed):
    n = len(uv1)
    want = jax_ransac(jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32), jnp.ones(n, bool),
                      jnp.eye(3, dtype=jnp.float32), jnp.asarray(K), jnp.asarray(D), jax.random.PRNGKey(seed))
    d1, d2 = _jax_draws(jax.random.PRNGKey(seed))
    got = two_point_ransac(torch.as_tensor(uv1, dtype=torch.float32)[None],
                           torch.as_tensor(uv2, dtype=torch.float32)[None], torch.ones(1, n, dtype=torch.bool),
                           torch.eye(3)[None], torch.as_tensor(K), torch.as_tensor(D),
                           torch.as_tensor(d1, dtype=torch.int64)[None], torch.as_tensor(d2, dtype=torch.int64)[None])
    return np.asarray(want), got[0].numpy()


def test_rejects_outliers():
    uv1, uv2, out = _translation_pair(np.random.default_rng(31))
    want, got = _both(uv1, uv2, 0)
    np.testing.assert_array_equal(got, want)
    assert not got[out].any(), "outliers survived"
    assert got[np.setdiff1d(np.arange(len(uv1)), out)].mean() > 0.85


def test_degenerate_motion():
    uv1, uv2 = _static_pair(np.random.default_rng(32))
    want, got = _both(uv1, uv2, 1)
    np.testing.assert_array_equal(got, want)
    assert not got[:5].any() and got[5:].mean() > 0.9


def test_too_few_points():
    uv1 = np.array([[100.0, 100.0], [200.0, 150.0]])
    want, got = _both(uv1, uv1 + 1.0, 2)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_lanes_equal_one_lane_calls():
    """Three lanes (two translations with their own outliers, one static
    camera), each with its own rotation and draws."""
    rng = np.random.default_rng(33)
    pairs = [_translation_pair(rng)[:2], _translation_pair(rng, t=np.array([-0.05, 0.03, 0.1]))[:2],
             _static_pair(rng, n=60)]
    R = torch.stack([torch.eye(3), torch.eye(3), torch.linalg.matrix_exp(torch.tensor(
        [[0.0, -0.01, 0.002], [0.01, 0.0, -0.003], [-0.002, 0.003, 0.0]]))])
    valid = torch.ones(3, 60, dtype=torch.bool)
    valid[1, ::7] = False
    d1, d2 = ransac_draws(torch.tensor([5, 17, 40], dtype=torch.int32), 0)
    args = (torch.as_tensor(np.stack([p[0] for p in pairs]), dtype=torch.float32),
            torch.as_tensor(np.stack([p[1] for p in pairs]), dtype=torch.float32), valid, R)
    got = two_point_ransac(*args, torch.as_tensor(K), torch.as_tensor(D), d1, d2)
    for b in range(3):
        alone = two_point_ransac(*(a[b : b + 1] for a in args), torch.as_tensor(K), torch.as_tensor(D),
                                 d1[b : b + 1], d2[b : b + 1])
        np.testing.assert_array_equal(got[b].numpy(), alone[0].numpy())
        assert not (got[b] & ~valid[b]).any()
    assert 0 < int(got[0].sum()) < 60 and 0 < int(got[1].sum()) < int(valid[1].sum())


def test_port_draws(monkeypatch):
    """In [0, 2^30), (B, H) per call, different across next_fid values and
    cameras, a pure function of them, and made without reading a tensor
    back to the host (every host conversion raises during the calls)."""
    nf = torch.tensor([0, 1, 2, 1000, 2**31 - 1], dtype=torch.int32)
    uv1, uv2, _ = _translation_pair(np.random.default_rng(34))
    pts = [torch.as_tensor(uv, dtype=torch.float32)[None] for uv in (uv1, uv2)]

    def host_read(*_args, **_kw):
        raise AssertionError("host read")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    draws = [ransac_draws(nf, cam) for cam in (0, 1)]
    again = ransac_draws(nf, 0)
    mask = two_point_ransac(*pts, torch.ones(1, 60, dtype=torch.bool), torch.eye(3)[None], torch.as_tensor(K),
                            torch.as_tensor(D), *ransac_draws(nf[:1], 0))
    monkeypatch.undo()

    assert mask.shape == (1, 60)
    assert torch.equal(again[0], draws[0][0]) and torch.equal(again[1], draws[0][1])
    rows = torch.cat([torch.cat(d, dim=1) for d in draws])  # (2 cameras x 5 lanes, 2H)
    assert rows.shape == (10, 2 * NUM_HYPOTHESES) and rows.dtype == torch.int64
    assert int(rows.min()) >= 0 and int(rows.max()) < 1 << 30
    assert len({tuple(r) for r in rows.tolist()}) == 10
    assert len(set(rows.flatten().tolist())) > 0.99 * rows.numel()
