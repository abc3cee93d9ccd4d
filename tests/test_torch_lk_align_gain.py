"""The plain versions of ``lk_corr_align_gain`` and ``resample_template``:
the compositions they replace, bit for bit, and the JAX package's functions
on the same numpy inputs; their wrappers' checks and launch counts.

Tolerances against JAX: final points within 5e-2 px (as
test_torch_klt_norm.py: a lane whose step sits at eps = 0.01 px may freeze
one step apart); resampled templates within 1e-4 grey levels of JAX's
tent-weight einsum (float32 sums in another association; measured maximum
noted at the assertion)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.ops.klt_corr as jkc
from msckf_stereo_c_torch.ops import _cuda
from msckf_stereo_c_torch.ops import klt_corr as kc
from msckf_stereo_c_torch.ops.patch_extract import extract_windows
from test_torch_klt_norm import jax_mode  # noqa: F401  (the fixture: interpret and XLA modes)
from test_torch_lk_align import LEVELS, _texture

torch.set_num_threads(1)

P, ITERS, EPS = 15, 30, 0.01
PT_TOL = 5e-2
TMPL_TOL = 1e-4


def _problem(seed, N, H, W, norm):
    """numpy and torch inputs of one lk_corr_align_gain call: templates in
    img0, search windows in a shifted copy under an exposure change (gain
    1.2, offset -10), int32 origins, the three filters of ``norm`` and sc
    (N, 12); every seventh lane starts frozen."""
    img0 = _texture(seed, H, W)
    img1 = (1.2 * np.roll(img0, (-2, 3), (0, 1)) - 10.0).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(12, W - 12, N), rng.uniform(12, H - 12, N)], 1).astype(np.float32)
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    sp = kc.extract_template(torch.as_tensor(img0), torch.as_tensor(pts), P)
    tq = kc._template_quantities(sp, P, norm)
    guess = torch.as_tensor(pts + np.float32([3.0, -2.0]))
    sorg = kc._clip_xy(torch.floor(guess) - S // 2, 0.0, W - S, H - S)
    frozen = ~tq.good
    frozen[::7] = True
    f0 = guess - (P - 1) / 2.0 - sorg
    return dict(img0=img0, img1=img1, sp=sp, tq=tq, S=S, sorg=sorg, org=sorg.to(torch.int32), f0=f0,
                filters=kc._filters_for_norm(tq, P, norm), sc=kc._k3_sc(tq, f0, frozen), frozen=frozen)


def _args(d, img=None):
    img = torch.as_tensor(d["img1"]) if img is None else img
    return (img, d["org"], d["S"], *d["filters"], d["sc"], ITERS, EPS, float(d["S"] - P - 1))


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("norm", ["gain", "offset"])
def test_align_gain_reference_is_the_composition_it_replaces(norm, level):
    """K2 -> _surfaces_for_norm -> K3 (the three launches the tracker ran
    for a three-surface problem before), bit for bit, and the surfaces it
    hands out are that composition's."""
    H, W = LEVELS[level]
    d = _problem(3, 40, H, W, norm)
    S, K = d["S"], d["S"] - P + 1
    img1 = torch.as_tensor(d["img1"])
    Cx, Cy, Ct = kc._surfaces_for_norm(extract_windows(img1, d["org"], S), d["tq"], P, norm)
    want = kc.lk_corr_iterate_gain(d["sc"], Cx, Cy, Ct, ITERS, EPS, float(K - 2))
    surf = torch.empty((40, 3, K, K))
    got = kc.lk_corr_align_gain(*_args(d), surfaces_out=surf)
    assert torch.equal(got, want)
    assert torch.equal(surf[:, 0], Cx) and torch.equal(surf[:, 1], Cy) and torch.equal(surf[:, 2], Ct)
    assert torch.equal(kc.lk_corr_align_gain_reference(*_args(d)), want)
    assert (~d["frozen"]).sum() > 20


@pytest.mark.parametrize("norm", ["gain", "offset"])
def test_align_gain_matches_jax(norm, jax_mode):  # noqa: F811
    """The JAX package's window copy (Pallas, interpret mode), surfaces
    (``_surfaces_for_norm``) and affine-photometric loop
    (``_run_iterations``: the Pallas K3 in interpret mode, or the XLA loop)
    on the same numpy inputs (measured max 1.9e-6 px in both modes)."""
    d = _problem(4, 40, 120, 188, norm)
    S = d["S"]
    jq = jkc._template_quantities(jnp.asarray(d["sp"].numpy()), P, norm)
    spatch = jkc._extract_at_origins(jnp.asarray(d["img1"]), jnp.asarray(d["sorg"].numpy()), S, "interpret")
    Cx, Cy, Ct = jkc._surfaces_for_norm(spatch, jq, P, norm)
    frozen = d["frozen"].numpy()
    f0 = d["f0"].numpy()
    want = np.asarray(jkc._run_iterations(Cx, Cy, Ct, jq, jnp.asarray(f0), jnp.asarray(frozen), ITERS, EPS,
                                          S, P, jax_mode))
    got = kc.lk_corr_align_gain(*_args(d)).numpy()
    assert (~frozen).sum() > 20
    assert np.abs(got - want)[~frozen].max() <= PT_TOL
    np.testing.assert_array_equal(got[frozen], f0[frozen])


def _resample_problem(seed, N, H, W):
    """An image, forward results pts (N, 2) and the int32 (Sb, Sb) block
    origins of the fused call's geometry, the first six lanes' offsets
    clamping at both ends of [0, Sb - (P+3)], on its ends and on integers."""
    img = _texture(seed, H, W)
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    Sb = S + 2
    rng = np.random.default_rng(seed + 1)
    guess = np.stack([rng.uniform(0, W - 1, N), rng.uniform(0, H - 1, N)], 1).astype(np.float32)
    o1 = np.clip(np.floor(guess) - S // 2 - 1, 0, [W - Sb, H - Sb]).astype(np.float32)
    pts = (guess + rng.uniform(-9, 9, (N, 2))).astype(np.float32)
    top = Sb - (P + 3)
    pts[:6] = o1[:6] + (P + 1) / 2.0 + np.float32(
        [[-2.5, -0.3], [top + 1.7, top + 0.2], [0, top], [3, 5], [4.75, 0.5], [top - 0.25, 1 - 2.0**-14]])
    return torch.as_tensor(img), torch.as_tensor(pts), torch.as_tensor(o1), Sb


@pytest.mark.parametrize("HW", [(60, 94), (120, 188)])
def test_resample_reference_is_the_fused_calls_expression(HW):
    """Bit for bit the expression the fused call ran before: K2's (Sb, Sb)
    block at o1 and the tent-weight einsum at ob = clamp(pts - (P+1)/2 -
    o1, 0, Sb - (P+3)), with lanes clamping at both ends; and within
    TMPL_TOL of the JAX fused call's expression on the same inputs
    (measured max 0: XLA's CPU einsum sums in the same order here)."""
    H, W = HW
    img, pts, o1, Sb = _resample_problem(5, 40, H, W)
    q = P + 2
    ob = torch.clamp(pts - (P + 1) / 2.0 - o1, 0.0, Sb - (P + 3.0))
    want = kc._sample(kc._tent_weights(ob[:, 1], q, Sb), extract_windows(img, o1.to(torch.int32), Sb),
                      kc._tent_weights(ob[:, 0], q, Sb))
    got = kc.resample_template(img, pts, o1.to(torch.int32), Sb, P)
    assert torch.equal(got, want)
    assert torch.equal(kc.resample_template_reference(img, pts, o1.to(torch.int32), Sb, P), want)
    jimg, jpts, jo1 = (jnp.asarray(x.numpy()) for x in (img, pts, o1))
    job = jnp.clip(jpts - (P + 1) / 2.0 - jo1, 0.0, Sb - (P + 3.0))
    jsp = jkc._sample(jkc._tent_weights(job[:, 1], q, Sb, jnp.float32),
                      jkc._extract_at_origins(jimg, jo1, Sb, "interpret"),
                      jkc._tent_weights(job[:, 0], q, Sb, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsp), rtol=0, atol=TMPL_TOL)


def test_image_index_stack_equals_separate_calls():
    """A (2, H, W) stack with a per-feature image index gives what two
    separate calls give, for both wrappers."""
    a, b = _problem(5, 24, 120, 188, "gain"), _problem(6, 24, 120, 188, "gain")
    imgs = torch.stack([torch.as_tensor(a["img1"]), torch.as_tensor(b["img1"])])
    index = torch.tensor([0] * 24 + [1] * 24, dtype=torch.int32)
    S, hi = a["S"], float(a["S"] - P - 1)
    org = torch.cat([a["org"], b["org"]])
    filters = [torch.cat([x, y]) for x, y in zip(a["filters"], b["filters"])]
    sc = torch.cat([a["sc"], b["sc"]])
    got = kc.lk_corr_align_gain(imgs, org, S, *filters, sc, ITERS, EPS, hi, img_index=index)
    one = kc.lk_corr_align_gain(*_args(a, imgs[0]))
    two = kc.lk_corr_align_gain(*_args(b, imgs[1]))
    assert torch.equal(got, torch.cat([one, two]))
    (ia, pa, oa, Sb), (ib, pb, ob_, _) = _resample_problem(7, 20, 120, 188), _resample_problem(8, 20, 120, 188)
    pts, o1 = torch.cat([pa, pb]), torch.cat([oa, ob_]).to(torch.int32)
    index = torch.tensor([0] * 20 + [1] * 20, dtype=torch.int32)
    tm = kc.resample_template(torch.stack([ia, ib]), pts, o1, Sb, P, index)
    assert torch.equal(tm[:20], kc.resample_template(ia, pa, o1[:20], Sb, P))
    assert torch.equal(tm[20:], kc.resample_template(ib, pb, o1[20:], Sb, P))


def test_wrappers_reject_bad_input_before_dispatch():
    """Shape, hi, window and shared-memory checks come before the device
    dispatch: meta tensors (no data, no kernel) raise the shape error, not
    an unsupported-device one."""
    m = dict(device="meta")
    img = torch.zeros((60, 94), **m)
    org = torch.zeros((4, 2), dtype=torch.int32, **m)
    g = torch.zeros((4, P, P), **m)
    S, hi = 35, 19.0
    cases = [
        (dict(sc=torch.zeros((4, 8), **m)), "sc"),
        (dict(origins=torch.zeros((4, 3), dtype=torch.int32, **m)), "origins"),
        (dict(gt=torch.zeros((4, P, P + 1), **m)), "filters"),
        (dict(gx=torch.zeros((3, P, P), **m)), "filters"),
        (dict(hi=20.0), "hi="),
        (dict(hi=-0.5), "hi="),
        # (S, P) = (80, 7): 4 * 80 * 84 + 16 * (49 + 74^2) = 115280 bytes.
        (dict(img=torch.zeros((200, 200), **m), S=80, gx=torch.zeros((4, 7, 7), **m),
              gy=torch.zeros((4, 7, 7), **m), gt=torch.zeros((4, 7, 7), **m), hi=70.0), "48 KB"),
        (dict(S=P), "window"),
        (dict(img=torch.zeros((2, 60, 94), **m)), "img_index"),
        (dict(surfaces_out=torch.zeros((4, 2, 21, 21), **m)), "surfaces_out"),
    ]
    for change, msg in cases:
        kw = dict(img=img, origins=org, S=S, gx=g, gy=g, gt=g, sc=torch.zeros((4, 12), **m), iters=ITERS,
                  eps=EPS, hi=hi)
        kw.update(change)
        with pytest.raises(ValueError, match=msg):
            kc.lk_corr_align_gain(**kw)
    with pytest.raises(ValueError, match="unsupported device"):
        kc.lk_corr_align_gain(img, org, S, g, g, g, torch.zeros((4, 12), **m), ITERS, EPS, hi)
    pts = torch.zeros((4, 2), **m)
    for args, msg in [
        ((img, torch.zeros((4, 3), **m), org, 37, P), "pts"),
        ((img, pts, torch.zeros((3, 2), dtype=torch.int32, **m), 37, P), "origins"),
        ((img, pts, org, 17, P), "block"),
        ((img, pts, org, 61, P), "block"),
        ((torch.zeros((2, 60, 94), **m), pts, org, 37, P), "img_index"),
        ((img, pts, org, 37, P), "unsupported device"),
    ]:
        with pytest.raises(ValueError, match=msg):
            kc.resample_template(*args)


def test_empty_calls_count_no_launch():
    """A call with no features returns an empty result on any device and
    counts no launch: the kernels launch nothing for it."""
    before = dict(_cuda.launch_counts)
    m = dict(device="meta")
    img = torch.zeros((60, 94), **m)
    org = torch.zeros((0, 2), dtype=torch.int32, **m)
    g = torch.zeros((0, P, P), **m)
    assert kc.lk_corr_align_gain(img, org, 35, g, g, g, torch.zeros((0, 12), **m), ITERS, EPS, 19.0).shape == (0, 2)
    assert kc.resample_template(img, torch.zeros((0, 2), **m), org, 37, P).shape == (0, P + 2, P + 2)
    assert _cuda.launch_counts == before


def test_plain_versions_count_no_launch():
    before = dict(_cuda.launch_counts)
    d = _problem(9, 8, 60, 94, "offset")
    kc.lk_corr_align_gain(*_args(d))
    kc.lk_corr_align_gain_reference(*_args(d))
    img, pts, o1, Sb = _resample_problem(9, 8, 60, 94)
    kc.resample_template(img, pts, o1.to(torch.int32), Sb, P)
    kc.resample_template_reference(img, pts, o1.to(torch.int32), Sb, P)
    assert _cuda.launch_counts == before
