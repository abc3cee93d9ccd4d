"""The unfused stereo calls against the JAX package: one ``frontend_step``
at a time on the bench scene (set-up and tolerances in
tests/_torch_frontend_scene.py) without template carry, without anchor
refinement, without the left-right check (carried templates and the
standalone anchor call) and with it on the candidates only; then
``_stereo_match_merged`` itself on a 36 x 600 image pair, under the fused
call's 37-pixel minimum: the carried-template call or the two-level LK, the
backward left-right pass over the union, and coarse levels too small for a
search window (tracked points within 5e-2 px, gates exact, inverse depths
within 5e-2 px of disparity, templates within 2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.models.frontend as jfe
import msckf_stereo_c_tpu.ops.klt_corr as jkc
from _torch_frontend_scene import PT_TOL, TMPL_TOL, jax_params, make_scene, run_both
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch import convert
from msckf_stereo_c_torch.models import frontend as tfe
from msckf_stereo_c_torch.ops.klt_corr import fused_stereo_supported

torch.set_num_threads(1)

OPTIONS = {
    "no_tmpl_carry": dict(tmpl_carry=False),
    "no_anchor_refine": dict(anchor_refine=False),
    "lr_threshold_0": dict(stereo_lr_threshold=0.0),
    "lr_candidates_only": dict(stereo_lr_survivors=False),
}
# The crop's stereo pair is a blurred noise texture seen 6 px apart; the
# epipolar gate is widened (the pair does not follow the EuRoC extrinsics).
CROP_CFGS = {
    "carried_templates": dict(stereo_threshold=40.0),
    "two_stereo_levels": dict(stereo_threshold=40.0, tmpl_carry=False, stereo_levels=2),
}


def _texture_pair(h=36, w=600, disparity=6, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, (h + 8, w + 40))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(2):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    crop0 = img[4 : 4 + h, 10 : 10 + w]
    crop1 = img[4 : 4 + h, 10 + disparity : 10 + disparity + w]
    return crop0.astype(np.float32), crop1.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.mark.parametrize("name", list(OPTIONS))
def test_frontend_step_matches_jax(scene, monkeypatch, name):
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    outs = run_both(OPTIONS[name], scene)
    assert int(outs[-1].after_ransac) > 15


@pytest.mark.parametrize("name", list(CROP_CFGS))
def test_stereo_match_on_a_small_crop(monkeypatch, name):
    monkeypatch.setattr(jkc, "_LOOP_MODE", "interpret")
    i0, i1 = _texture_pair()
    assert not fused_stereo_supported(i0.shape, 15)
    fcfg = jconfig.FrontendConfig(max_features=48, **CROP_CFGS[name])
    tfcfg = tconfig.FrontendConfig(max_features=48, **CROP_CFGS[name])
    # Both principal points moved to the crop's centre.
    jp = jax_params()
    shift = jnp.concatenate([jnp.zeros(2, jnp.float32), jp.K0[2:] - jnp.asarray([300.0, 18.0], jnp.float32)])
    jp = jp._replace(K0=jp.K0 - shift, K1=jp.K1 - shift)
    tp = convert.from_numpy(jax.device_get(jp))
    shape = i0.shape
    p0, p1 = jfe.pyramids_for(jnp.asarray(i0), fcfg), jfe.pyramids_for(jnp.asarray(i1), fcfg)

    # Survivors and candidates: FAST corners of the crop, split in two.
    xy, _, ok = jfe._detect_candidates(jnp.zeros((1, 2)), jnp.zeros(1, bool), p0[0], fcfg, shape)
    xy = np.asarray(xy)[np.asarray(ok)]
    assert xy.shape[0] >= 16
    n = xy.shape[0] // 2
    surv, cand = xy[:n] + 0.3, xy[n:]
    surv_guess = surv - np.array([6.5, 0.2], np.float32)
    args = (surv, surv_guess, np.ones(n, bool), cand, np.ones(len(cand), bool))

    want = jax.jit(lambda *a: jfe._stereo_match_merged(p0, p1, *a, jp, fcfg, shape))(*map(jnp.asarray, args))
    got = tfe._stereo_match_merged(
        tfe.pyramids_for(torch.as_tensor(i0), tfcfg), tfe.pyramids_for(torch.as_tensor(i1), tfcfg),
        *(torch.as_tensor(a)[None] for a in args), tp, tfcfg, shape,
    )
    (ws, wc, wt, wn, wm), (gs, gc, gt, gn, gm) = jax.device_get(want), got
    ok_s, ok_c = np.asarray(ws[2]), np.asarray(wc[1])
    np.testing.assert_array_equal(gs[2][0].numpy(), ok_s)
    np.testing.assert_array_equal(gc[1][0].numpy(), ok_c)
    assert ok_s.sum() >= 8 and ok_c.sum() >= 2, "the crop matched too little to test"
    for w, g, m in ((ws[0], gs[0], ok_s), (ws[1], gs[1], ok_s), (wc[0], gc[0], ok_c)):
        np.testing.assert_allclose(g[0].numpy()[m], np.asarray(w)[m], rtol=0, atol=PT_TOL)
    # Depths as inverse depths (the disparity over the baseline), within the
    # points' tolerance.
    fx, base = float(jp.K0[0]), float(np.linalg.norm(np.asarray(jp.t_c0_c1)[:2]))
    for w, g in ((ws[3], gs[3]), (wc[2], gc[2])):
        w, g = np.asarray(w), g[0].numpy()
        np.testing.assert_array_equal(g > 0, w > 0)
        np.testing.assert_allclose(1.0 / g[w > 0], 1.0 / w[w > 0], rtol=0, atol=PT_TOL / fx / base)
    assert int(gn[0]) == int(wn) == 0
    assert wm == (None, None) and gm == (None, None)
    if wt[0] is None:
        assert gt == (None, None)
    else:
        for w, g in zip(wt, gt):
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=0, atol=TMPL_TOL)
