"""Correlation-surface LK of the port (the plain K1 loop and the three LK
entry points of the main path) against the JAX package.

The JAX side runs both ways its own tests run it on the CPU: with the Pallas
iteration kernel in interpret mode (``_LOOP_MODE = "interpret"``, which also
takes the (P+3)-window template formula the port always uses) and with the
XLA loop (``"xla"``, whose (P+4) tent-weight template agrees only to
rounding).  Both sides get the same numpy images.

Tolerance: boolean masks (valid, accept, finite round trip) identical;
points within 5e-2 px, the precedent of tests/test_klt_corr.py, since a
lane whose step sits at eps = 0.01 px may freeze one step apart.  Measured
maxima on these inputs are noted at each assertion."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch.ops import klt_corr as tkc

torch.set_num_threads(1)

P, ITERS, EPS = 15, 30, 0.01
PT_TOL = 5e-2
MODES = ["interpret", "xla"]


def _texture(seed, H=160, W=224):
    rng = np.random.default_rng(seed)
    img = 60.0 + 20.0 * np.sin(np.arange(W) / 13.0)[None, :] + 15.0 * np.cos(np.arange(H) / 9.0)[:, None]
    yy, xx = np.mgrid[-4:5, -4:5]
    for _ in range(110):
        x, y = rng.integers(8, W - 8), rng.integers(8, H - 8)
        img[y - 4 : y + 5, x - 4 : x + 5] += rng.uniform(60, 150) * np.exp(-(xx**2 + yy**2) / 4.0)
    return np.clip(img, 0, 255).astype(np.float32)


def _shifted(img, dx, dy):
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, M, (img.shape[1], img.shape[0]), borderMode=cv2.BORDER_REFLECT_101)


def _pyr(img, levels):
    out = [img]
    for _ in range(levels - 1):
        out.append(cv2.pyrDown(out[-1]))
    return out


def _points(seed, n, H, W, margin=12):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)], 1).astype(
        np.float32
    )


def _t(x):
    return torch.as_tensor(np.array(x))


def _max_err(a, b, mask):
    a, b, mask = np.asarray(a), np.asarray(b), np.asarray(mask)
    return float(np.max(np.abs(a - b)[mask])) if mask.any() else 0.0


@pytest.fixture(params=MODES)
def jax_mode(request, monkeypatch):
    monkeypatch.setattr(jkc, "_LOOP_MODE", request.param)
    return request.param


def test_run_iterations(jax_mode):
    """The plain K1 loop against JAX's _run_iterations on identical
    correlation surfaces (measured max 1.2e-4 px, both modes)."""
    img0 = _texture(0)
    img1 = _shifted(img0, 2.3, -1.7)
    H, W = img0.shape
    S = P + 2 * jkc._SEARCH_RADIUS + 2
    pts = _points(1, 40, H, W, margin=20)
    guess = pts + np.float32([1.5, -1.0])
    sp = jkc._interp_template(jnp.asarray(img0), jnp.asarray(pts), P, "interpret")
    tq = jkc._template_quantities(sp, P)
    sorg = np.clip(np.floor(guess) - S // 2, 0, [W - S, H - S]).astype(np.float32)
    spatch = jkc._extract_at_origins(jnp.asarray(img1), jnp.asarray(sorg), S, "xla")
    Cx, Cy = jkc._corr_surfaces(spatch, tq.gx, tq.gy, P)
    f0 = guess - (P - 1) / 2.0 - sorg
    # Every fifth lane starts frozen, as a bad template would.
    frozen = ~np.asarray(tq.good)
    frozen[::5] = True
    want = jkc._run_iterations(
        Cx, Cy, None, tq, jnp.asarray(f0), jnp.asarray(frozen), ITERS, EPS, S, P,
        jkc._resolve_mode(),
    )
    tq_t = tkc._template_quantities(_t(sp), P)
    np.testing.assert_array_equal(tq_t.good.numpy(), np.asarray(tq.good))
    got = tkc._run_iterations(_t(Cx), _t(Cy), tq_t, _t(f0), _t(frozen), ITERS, EPS, S, P)
    assert (~frozen).sum() > 25
    assert _max_err(got.numpy(), want, ~frozen) <= PT_TOL
    # Frozen lanes return their start point on both sides.
    np.testing.assert_array_equal(got.numpy()[frozen], f0[frozen])
    np.testing.assert_array_equal(np.asarray(want)[frozen], f0[frozen])


def test_optical_flow_lk_corr_l0(jax_mode):
    """Temporal single-level LK, first extracting the templates, then reusing
    them as the carried templates (measured max 1.1e-4 px in interpret
    mode, 3.3e-4 px in xla mode; templates equal in interpret mode and
    within 3.1e-5 in xla mode)."""
    img0 = _texture(2)
    img1 = _shifted(img0, -3.2, 2.6)
    H, W = img0.shape
    pts = _points(3, 48, H, W)
    guess = pts + np.float32([-2.5, 2.0])
    valid = np.ones(48, bool)
    valid[::7] = False
    jres, jsp = jkc.optical_flow_lk_corr_l0(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(guess),
        jnp.asarray(valid), P, ITERS, EPS, want_tmpl=True,
    )
    tres, tsp = tkc.optical_flow_lk_corr_l0(
        _t(img0), _t(img1), _t(pts), _t(guess), _t(valid), P, ITERS, EPS, want_tmpl=True
    )
    ok = np.asarray(jres.valid)
    np.testing.assert_array_equal(tres.valid.numpy(), ok)
    assert ok.sum() > 25
    assert _max_err(tres.pts.numpy(), jres.pts, ok) <= PT_TOL
    # The template formula is the same as interpret mode's: equal to f32
    # rounding there; the xla path's tent-weight template agrees to 1e-3.
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), atol=1e-3 if jax_mode == "xla" else 1e-4)

    jres2, _ = jkc.optical_flow_lk_corr_l0(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(guess),
        jnp.asarray(valid), P, ITERS, EPS, tmpl_sp=jsp,
    )
    tres2, none = tkc.optical_flow_lk_corr_l0(
        _t(img0), _t(img1), _t(pts), _t(guess), _t(valid), P, ITERS, EPS, tmpl_sp=tsp
    )
    assert none is None
    np.testing.assert_array_equal(tres2.valid.numpy(), np.asarray(jres2.valid))
    assert _max_err(tres2.pts.numpy(), jres2.pts, np.asarray(jres2.valid)) <= PT_TOL


def test_optical_flow_pyr_lk_corr(jax_mode):
    """The candidates' coarse walk: three levels, coarse to fine, from a
    guess 8 px off (measured max 5.1e-4 px in interpret mode, 5.3e-4 px in
    xla mode)."""
    img0 = _texture(4, 240, 320)
    img1 = _shifted(img0, 6.4, -5.1)
    pyr0, pyr1 = _pyr(img0, 3), _pyr(img1, 3)
    H, W = img0.shape
    pts = _points(5, 48, H, W, margin=30)
    guess = pts.copy()
    valid = np.ones(48, bool)
    jres = jkc.optical_flow_pyr_lk_corr(
        [jnp.asarray(p) for p in pyr0], [jnp.asarray(p) for p in pyr1], jnp.asarray(pts),
        jnp.asarray(guess), jnp.asarray(valid), P, ITERS, EPS,
    )
    tres = tkc.optical_flow_pyr_lk_corr(
        [_t(p) for p in pyr0], [_t(p) for p in pyr1], _t(pts), _t(guess), _t(valid), P, ITERS, EPS
    )
    ok = np.asarray(jres.valid)
    np.testing.assert_array_equal(tres.valid.numpy(), ok)
    assert ok.sum() > 30
    assert _max_err(tres.pts.numpy(), jres.pts, ok) <= PT_TOL
    np.testing.assert_allclose(np.asarray(jres.pts)[ok], (pts + [6.4, -5.1])[ok], atol=0.2)


def test_stereo_anchor_lr_fused(jax_mode):
    """The fused stereo + anchor + left-right fine level (measured max, both
    modes: refined cam0 points 2.3e-5 px, forward points 6.4e-5 px, round
    trip 1.4e-4 px, templates 6.9e-4 grey levels)."""
    img0 = _texture(6)
    img1 = _shifted(img0, -4.6, 0.3)
    H, W = img0.shape
    N, A = 40, 24
    pts0 = _points(7, N, H, W, margin=10)
    rng = np.random.default_rng(8)
    guess = (pts0 + np.float32([-4.6, 0.3]) + rng.uniform(-1.5, 1.5, (N, 2))).astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    # Birth templates at positions up to 1.5 px from the current points.
    birth = (pts0[:A] + rng.uniform(-1.5, 1.5, (A, 2))).astype(np.float32)
    anchor = jkc._interp_template(jnp.asarray(img0), jnp.asarray(birth), P, "interpret")
    anchor_valid = valid[:A].copy()
    jout = jkc.stereo_anchor_lr_fused(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts0), jnp.asarray(guess),
        jnp.asarray(valid), P, ITERS, EPS, anchor_sp=anchor, anchor_valid=jnp.asarray(anchor_valid),
    )
    tout = tkc.stereo_anchor_lr_fused(
        _t(img0), _t(img1), _t(pts0), _t(guess), _t(valid), P, ITERS, EPS,
        anchor_sp=_t(anchor), anchor_valid=_t(anchor_valid),
    )
    jp0, jacc, jrt2, jsp, jme = (np.asarray(jout[i]) for i in (0, 1, 3, 4, 5))
    jres = jout[2]
    tp0, tacc, tres, trt2, tsp, tme = tout
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    assert jacc.sum() > 10
    assert _max_err(tp0.numpy(), jp0, np.ones(N, bool)) <= PT_TOL
    ok = np.asarray(jres.valid)
    np.testing.assert_array_equal(tres.valid.numpy(), ok)
    assert ok.sum() > 25
    assert _max_err(tres.pts.numpy(), jres.pts, ok) <= PT_TOL
    fin = np.isfinite(jrt2)
    np.testing.assert_array_equal(np.isfinite(trt2.numpy()), fin)
    # rt2 is a squared distance of about 1e-3 px^2; compare its root.
    assert _max_err(np.sqrt(trt2.numpy()), np.sqrt(jrt2), fin) <= PT_TOL
    # Templates are sampled at the anchor-refined points, which agree to
    # ~1e-5 px; times image gradients up to ~60 grey levels/px.
    np.testing.assert_allclose(tsp.numpy(), jsp, atol=2e-3)
    np.testing.assert_allclose(tme.numpy(), jme, rtol=1e-3, atol=1e-6)
