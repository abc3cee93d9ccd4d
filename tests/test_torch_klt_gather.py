"""The bilinear-gather LK (``ops/klt.py``, ``klt_impl='gather'``, and in the
port ``'gemm'``) against the JAX package's, on tests/test_klt_gemm.py's
images: a blob texture shifted by (4.3, -3.1) px.

Tolerances: validity exact; points within 1e-3 px of JAX's gather LK (the
same arithmetic, summed in another order); within 5e-2 px of JAX's GEMM
resampling, tests/test_klt_gemm.py's tolerance between JAX's two.  Lanes
folded into the feature axis equal the lane-by-lane calls bit for bit."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.models.frontend import _klt_fn
from msckf_stereo_c_torch.ops.klt import optical_flow_pyr_lk
from msckf_stereo_c_tpu.ops.klt import optical_flow_pyr_lk as jax_gather
from msckf_stereo_c_tpu.ops.klt_gemm import optical_flow_pyr_lk_gemm as jax_gemm

torch.set_num_threads(1)

GATHER_TOL = 1e-3
GEMM_TOL = 5e-2
SHIFT = np.array([4.3, -3.1], np.float32)


def _test_image(H=240, W=320, n_blobs=70, seed=5):
    rng = np.random.default_rng(seed)
    img = 60.0 + 20.0 * np.sin(np.arange(W) / 13.0)[None, :] + 15.0 * np.cos(np.arange(H) / 9.0)[:, None]
    yy, xx = np.mgrid[-4:5, -4:5]
    for _ in range(n_blobs):
        x, y = rng.integers(8, W - 8), rng.integers(8, H - 8)
        a = rng.uniform(60, 150)
        img[y - 4 : y + 5, x - 4 : x + 5] += a * np.exp(-(xx**2 + yy**2) / 4.0)
    return np.clip(img, 0, 255).astype(np.float32)


def _pyr(img, levels):
    out = [img]
    for _ in range(levels - 1):
        out.append(cv2.pyrDown(out[-1]))
    return out


def _pair(seed=5, levels=4):
    img = _test_image(seed=seed)
    M = np.float32([[1, 0, SHIFT[0]], [0, 1, SHIFT[1]]])
    return _pyr(img, levels), _pyr(cv2.warpAffine(img, M, (320, 240)), levels)


def _points(n=24, seed=0):
    return np.random.default_rng(seed).uniform(40, 200, (n, 2)).astype(np.float32)


def _port(fn, pyr_a, pyr_b, pts, guess):
    res = fn([torch.as_tensor(x) for x in pyr_a], [torch.as_tensor(x) for x in pyr_b], torch.as_tensor(pts),
             torch.as_tensor(guess), torch.ones(len(pts), dtype=torch.bool), win=15, iters=30, eps=0.01)
    return res.pts.numpy(), res.valid.numpy()


@pytest.mark.parametrize("levels", [1, 4])
def test_gather_matches_jax(levels):
    pyr_a, pyr_b = _pair(levels=levels)
    pts = _points()
    guess = pts + (SHIFT if levels == 1 else 0.0) + 0.4  # one level searches from near the answer
    want = jax_gather([jnp.asarray(x) for x in pyr_a], [jnp.asarray(x) for x in pyr_b], jnp.asarray(pts),
                      jnp.asarray(guess), jnp.ones(len(pts), bool), 15, 30, 0.01)
    got_pts, got_valid = _port(optical_flow_pyr_lk, pyr_a, pyr_b, pts, guess)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got_valid, ok)
    assert ok.sum() >= 12
    np.testing.assert_allclose(got_pts[ok], np.asarray(want.pts)[ok], rtol=0, atol=GATHER_TOL)
    np.testing.assert_allclose(got_pts[ok], (pts + SHIFT)[ok], rtol=0, atol=0.2)


def test_gemm_is_served_by_the_gather_lk():
    """``klt_impl='gemm'`` runs the gather LK, within tests/test_klt_gemm.py's
    tolerance of JAX's matmul resampling."""
    assert _klt_fn("gemm") is optical_flow_pyr_lk and _klt_fn("gather") is optical_flow_pyr_lk
    with pytest.raises(ValueError, match="unknown klt_impl"):
        _klt_fn("matmul")
    pyr_a, pyr_b = _pair()
    pts = _points()
    want = jax_gemm([jnp.asarray(x) for x in pyr_a], [jnp.asarray(x) for x in pyr_b], jnp.asarray(pts),
                    jnp.asarray(pts), jnp.ones(len(pts), bool), 15, 30, 0.01)
    got_pts, got_valid = _port(_klt_fn("gemm"), pyr_a, pyr_b, pts, pts)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got_valid, ok)
    np.testing.assert_allclose(got_pts[ok], np.asarray(want.pts)[ok], rtol=0, atol=GEMM_TOL)


def test_lanes_equal_lane_by_lane_calls():
    """Two image pairs as a (2, h, w) stack per level with an image index,
    and one image shared by both lanes (a broadcast stack)."""
    pairs = [_pair(seed=s) for s in (5, 9)]
    pts = [_points(seed=s) for s in (0, 1)]
    alone = [_port(optical_flow_pyr_lk, a, b, p, p) for (a, b), p in zip(pairs, pts)]
    stack = [[torch.stack([torch.as_tensor(pairs[0][j][lvl]), torch.as_tensor(pairs[1][j][lvl])])
              for lvl in range(4)] for j in (0, 1)]
    idx = torch.arange(2, dtype=torch.int32).repeat_interleave(24)
    p = torch.as_tensor(np.concatenate(pts))
    res = optical_flow_pyr_lk(stack[0], stack[1], p, p, torch.ones(48, dtype=torch.bool), img_index=idx)
    for b in range(2):
        np.testing.assert_array_equal(res.pts.numpy()[24 * b : 24 * (b + 1)], alone[b][0])
        np.testing.assert_array_equal(res.valid.numpy()[24 * b : 24 * (b + 1)], alone[b][1])

    shared = [[torch.as_tensor(x).expand(2, *x.shape) for x in pairs[0][j]] for j in (0, 1)]
    p0 = torch.as_tensor(np.concatenate([pts[0], pts[0]]))
    res = optical_flow_pyr_lk(shared[0], shared[1], p0, p0, torch.ones(48, dtype=torch.bool), img_index=idx)
    for b in range(2):
        np.testing.assert_array_equal(res.pts.numpy()[24 * b : 24 * (b + 1)], alone[0][0])
