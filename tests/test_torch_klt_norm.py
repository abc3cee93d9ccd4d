"""The photometric LK norms of the port (``klt_norm``; ops/klt_corr.py
``_template_quantities``, ``_surfaces_for_norm``, the plain K3 loop and the
LK entry points with ``norm``) against the JAX package.

The JAX side runs both ways its own tests run on the CPU: the Pallas
iteration kernels in interpret mode (``_LOOP_MODE = "interpret"``) and the
XLA loop (``"xla"``).  Both sides get the same numpy inputs.

Tolerances: template quantities and surfaces within 1e-4 relative to each
field's largest magnitude (float32 sums in another order; the bordered
inverse rows are products of such sums); boolean masks identical; points
within 5e-2 px, the precedent of tests/test_klt_corr.py, since a lane whose
step sits at eps = 0.01 px may freeze one step apart.  Measured maxima on
these inputs are noted at the assertions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.models.frontend as jfrontend
import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.models import frontend as tfrontend
from msckf_stereo_c_torch.ops import klt_corr as tkc
from test_klt_norm import _tracking_setup

torch.set_num_threads(1)

P, ITERS, EPS = 15, 30, 0.01
PT_TOL = 5e-2
REL_TOL = 1e-4
NORMS = ["none", "zeromean", "offset", "gain"]
MODES = ["interpret", "xla"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _max_err(a, b, mask):
    a, b, mask = np.asarray(a), np.asarray(b), np.asarray(mask)
    return float(np.max(np.abs(a - b)[mask])) if mask.any() else 0.0


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * max(np.abs(want).max(), 1e-6))


@pytest.fixture(params=MODES)
def jax_mode(request, monkeypatch):
    monkeypatch.setattr(jkc, "_LOOP_MODE", request.param)
    return request.param


def _problem(gain=1.3, offset=15.0, n=40):
    """Templates at img0 points and search windows in a gain/offset-changed,
    shifted img1 (the scene of tests/test_klt_norm.py), as numpy."""
    img0, img1, pts0, _, guess = (np.asarray(x) for x in _tracking_setup(gain, offset, n=n))
    H, W = img0.shape
    S = P + 2 * jkc._SEARCH_RADIUS + 2
    sp = np.asarray(jkc._interp_template(jnp.asarray(img0), jnp.asarray(pts0), P, "interpret"))
    sorg = np.clip(np.floor(guess) - S // 2, 0, [W - S, H - S]).astype(np.float32)
    spatch = np.asarray(jkc._extract_at_origins(jnp.asarray(img1), jnp.asarray(sorg), S, "xla"))
    f0 = (guess - (P - 1) / 2.0 - sorg).astype(np.float32)
    return sp, spatch, f0, S


@pytest.mark.parametrize("norm", NORMS)
def test_template_quantities_and_surfaces(norm):
    """Every TemplateQ field the norm sets, and the (Cx, Cy, Ct) surfaces
    (measured max relative error 3.7e-6, under 'gain')."""
    sp, spatch, _, _ = _problem()
    jq = jkc._template_quantities(jnp.asarray(sp), P, norm)
    tq = tkc._template_quantities(_t(sp), P, norm)
    for name in jkc.TemplateQ._fields:
        want = getattr(jq, name)
        got = getattr(tq, name)
        assert (got is None) == (want is None), name
        if want is None:
            continue
        if name == "good":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got.numpy(), want)
    jsurf = jkc._surfaces_for_norm(jnp.asarray(spatch), jq, P, norm)
    tsurf = tkc._surfaces_for_norm(_t(spatch), tq, P, norm)
    assert (tsurf[2] is None) == (jsurf[2] is None) == (norm in ("none", "zeromean"))
    for got, want in zip(tsurf, jsurf):
        if want is not None:
            _close(got.numpy(), want)


@pytest.mark.parametrize("norm", ["offset", "gain"])
def test_gain_loop_reference_matches_jax(norm, jax_mode):
    """The plain K3 loop against the Pallas kernel in interpret mode
    (``_iterate_fn_gain``) and against JAX's XLA loop with a Ct, on the same
    surfaces; every fifth lane starts frozen (measured max 2.9e-6 px
    against interpret mode, 4.8e-6 px against the XLA loop)."""
    sp, spatch, f0, S = _problem()
    jq = jkc._template_quantities(jnp.asarray(sp), P, norm)
    Cx, Cy, Ct = (np.asarray(c) for c in jkc._surfaces_for_norm(jnp.asarray(spatch), jq, P, norm))
    frozen = ~np.asarray(jq.good)
    frozen[::5] = True
    B = np.asarray(jq.Binv)
    sc = np.stack(
        [B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1], B[:, 1, 2],
         np.asarray(jq.tgx), np.asarray(jq.tgy), np.asarray(jq.st2),
         f0[:, 0], f0[:, 1], frozen.astype(np.float32)], -1,
    ).astype(np.float32)
    N, K, _ = Cx.shape
    hi = float(S - P - 1)
    if jax_mode == "interpret":
        run = jkc._iterate_fn_gain(K, ITERS, EPS, hi, True)
        want = run(jnp.asarray(np.pad(sc, ((0, 0), (0, 4)))), jnp.asarray(Cx.reshape(N, -1)),
                   jnp.asarray(Cy.reshape(N, -1)), jnp.asarray(Ct.reshape(N, -1)))
    else:
        want = jkc._run_iterations(
            jnp.asarray(Cx), jnp.asarray(Cy), jnp.asarray(Ct), jq, jnp.asarray(f0),
            jnp.asarray(frozen), ITERS, EPS, S, P, "xla",
        )
    got = tkc.lk_corr_iterate_gain_reference(_t(sc), _t(Cx), _t(Cy), _t(Ct), ITERS, EPS, hi)
    assert (~frozen).sum() > 25
    assert _max_err(got.numpy(), want, ~frozen) <= PT_TOL
    np.testing.assert_array_equal(got.numpy()[frozen], f0[frozen])
    # The wrapper on a CPU tensor is the plain version.
    wrapped = tkc.lk_corr_iterate_gain(_t(sc), _t(Cx), _t(Cy), _t(Ct), ITERS, EPS, hi)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("norm", NORMS)
def test_optical_flow_lk_corr_l0(norm, jax_mode):
    """Single-level LK under gain 1.3 and offset +15 DN, in every norm
    (measured max 9.2e-5 px over norms and modes)."""
    img0, img1, pts0, true1, guess = (np.asarray(x) for x in _tracking_setup(1.3, 15.0))
    n = pts0.shape[0]
    valid = np.ones(n, bool)
    valid[::9] = False
    jres, _ = jkc.optical_flow_lk_corr_l0(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts0), jnp.asarray(guess),
        jnp.asarray(valid), P, ITERS, EPS, norm=norm,
    )
    tres, _ = tkc.optical_flow_lk_corr_l0(
        _t(img0), _t(img1), _t(pts0), _t(guess), _t(valid), P, ITERS, EPS, norm=norm
    )
    ok = np.asarray(jres.valid)
    np.testing.assert_array_equal(tres.valid.numpy(), ok)
    assert ok.sum() > 25
    assert _max_err(tres.pts.numpy(), jres.pts, ok) <= PT_TOL
    if norm == "gain":
        # The affine-photometric solve lands on the true shift despite the
        # gain and offset mismatch.
        assert np.median(np.linalg.norm(tres.pts.numpy() - true1, axis=1)[ok]) < 0.1


def test_stereo_anchor_lr_fused_offset_and_gain(jax_mode):
    """The fused stereo + anchor + left-right level with the 'mixed' norms:
    'offset' for the forward and backward problems, 'gain' for the anchor
    (measured max over both modes: points 4.6e-5 px, round trip 6.1e-5
    px)."""
    img0, img1, pts0, _, guess = (np.asarray(x) for x in _tracking_setup(1.3, 15.0, n=40))
    rng = np.random.default_rng(8)
    N, A = 40, 24
    valid = rng.uniform(size=N) < 0.9
    birth = (pts0[:A] + rng.uniform(-1.5, 1.5, (A, 2))).astype(np.float32)
    # Birth templates from a darker exposure of the same scene.
    anchor = np.asarray(jkc._interp_template(jnp.asarray(0.8 * img0 - 5.0), jnp.asarray(birth), P, "interpret"))
    kw = dict(norm="offset", anchor_norm="gain")
    jout = jkc.stereo_anchor_lr_fused(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts0), jnp.asarray(guess),
        jnp.asarray(valid), P, ITERS, EPS, anchor_sp=jnp.asarray(anchor),
        anchor_valid=jnp.asarray(valid[:A]), **kw,
    )
    tout = tkc.stereo_anchor_lr_fused(
        _t(img0), _t(img1), _t(pts0), _t(guess), _t(valid), P, ITERS, EPS,
        anchor_sp=_t(anchor), anchor_valid=_t(valid[:A]), **kw,
    )
    jp0, jacc, jrt2, jsp, jme = (np.asarray(jout[i]) for i in (0, 1, 3, 4, 5))
    tp0, tacc, tres, trt2, tsp, tme = tout
    np.testing.assert_array_equal(tacc.numpy(), jacc)
    assert jacc.sum() > 10
    assert _max_err(tp0.numpy(), jp0, np.ones(N, bool)) <= PT_TOL
    ok = np.asarray(jout[2].valid)
    np.testing.assert_array_equal(tres.valid.numpy(), ok)
    assert ok.sum() > 25
    assert _max_err(tres.pts.numpy(), jout[2].pts, ok) <= PT_TOL
    fin = np.isfinite(jrt2)
    np.testing.assert_array_equal(np.isfinite(trt2.numpy()), fin)
    assert _max_err(np.sqrt(trt2.numpy()), np.sqrt(jrt2), fin) <= PT_TOL
    np.testing.assert_allclose(tsp.numpy(), jsp, atol=2e-3)
    np.testing.assert_allclose(tme.numpy(), jme, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("klt_norm", ["none", "zeromean", "offset", "gain", "mixed", "anchor_gain"])
def test_norms(klt_norm):
    """(frame-to-frame, anchor) norms for every klt_norm value, as JAX's."""
    want = jfrontend._norms(jconfig.FrontendConfig(klt_norm=klt_norm))
    assert tfrontend._norms(tconfig.FrontendConfig(klt_norm=klt_norm)) == want


def test_unknown_norm_raises():
    sp, _, _, _ = _problem(n=4)
    with pytest.raises(ValueError):
        tkc._template_quantities(_t(sp), P, "affine")
