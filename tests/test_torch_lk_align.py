"""The plain versions of ``lk_corr_align`` and ``extract_template``: the
compositions they replace, bit for bit, and the JAX package's functions on
the same numpy inputs; their wrappers' checks; and the image sector counts
behind the bounds in ``chip_smoke.py``.

Tolerances against JAX: final points within 5e-2 px (as
test_torch_klt_corr.py: a lane whose step sits at eps = 0.01 px may freeze
one step apart); templates within 1e-4 grey levels of the interpret path,
which runs the same (P+3)-window formula."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_stereo_c_tpu.ops.klt_corr as jkc
from chip_smoke import footprint_sectors, window_sectors
from msckf_stereo_c_torch.ops import _cuda
from msckf_stereo_c_torch.ops import klt_corr as kc
from msckf_stereo_c_torch.ops.patch_extract import extract_windows

torch.set_num_threads(1)

P, ITERS, EPS = 15, 30, 0.01
PT_TOL = 5e-2
# (H, W) of pyramid levels 0 and 3 of the 752x480 main path; level 3's
# search window is min(35, H, W) = 35 as at level 0.
LEVELS = {"level0": (480, 752), "level3": (60, 94)}


def _texture(seed, H, W):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 255, (H // 6 + 1, W // 6 + 1)), np.ones((6, 6)))[:H, :W]
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), axis, img)
    return img.astype(np.float32)


def _problem(seed, N, H, W, norm):
    """numpy inputs of one lk_corr_align call: the next image, int32 search
    origins, S, the two filters, sc (N, 8), and the points and templates
    they came from."""
    img0 = _texture(seed, H, W)
    img1 = np.roll(img0, (-2, 3), (0, 1)) * 1.1 + 4.0
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(12, W - 12, N), rng.uniform(12, H - 12, N)], 1).astype(np.float32)
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    sp = kc.extract_template(torch.as_tensor(img0), torch.as_tensor(pts), P)
    tq = kc._template_quantities(sp, P, norm)
    guess = torch.as_tensor(pts + np.float32([3.0, -2.0]))
    sorg = kc._clip_xy(torch.floor(guess) - S // 2, 0.0, W - S, H - S)
    gx, gy = (tq.gx, tq.gy) if norm == "none" else kc._centred_filters(tq, P)
    frozen = ~tq.good
    frozen[::7] = True
    sc = kc._k1_sc(tq, guess - (P - 1) / 2.0 - sorg, frozen)
    return dict(img0=img0, img1=img1, pts=pts, sp=sp, tq=tq, S=S, sorg=sorg,
                org=sorg.to(torch.int32), gx=gx, gy=gy, sc=sc, frozen=frozen)


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("norm", ["none", "zeromean"])
def test_align_reference_is_the_composition_it_replaces(norm, level):
    """extract_windows -> _corr_surfaces -> lk_corr_iterate, bit for bit,
    and the surfaces it hands out are that composition's."""
    H, W = LEVELS[level]
    d = _problem(3, 40, H, W, norm)
    S, K = d["S"], d["S"] - P + 1
    img1 = torch.as_tensor(d["img1"])
    Cx, Cy = kc._corr_surfaces(extract_windows(img1, d["org"], S), d["gx"], d["gy"], P)
    want = kc.lk_corr_iterate(d["sc"], Cx, Cy, ITERS, EPS, float(K - 2))
    surf = torch.empty((40, 2, K, K))
    got = kc.lk_corr_align(img1, d["org"], S, d["gx"], d["gy"], d["sc"], ITERS, EPS, float(K - 2),
                           surfaces_out=surf)
    assert torch.equal(got, want)
    assert torch.equal(surf[:, 0], Cx) and torch.equal(surf[:, 1], Cy)
    assert (~d["frozen"]).sum() > 20


@pytest.mark.parametrize("norm", ["none", "zeromean"])
def test_align_matches_jax(norm):
    """The JAX package's window copy, surfaces and LK loop (Pallas kernels
    in interpret mode) on the same numpy inputs."""
    d = _problem(4, 40, 120, 188, norm)
    S = d["S"]
    jsp = jkc._interp_template(jnp.asarray(d["img0"]), jnp.asarray(d["pts"]), P, "interpret")
    np.testing.assert_allclose(d["sp"].numpy(), np.asarray(jsp), atol=1e-4)
    jq = jkc._template_quantities(jnp.asarray(d["sp"].numpy()), P, norm)
    sorg = d["sorg"].numpy()
    spatch = jkc._extract_at_origins(jnp.asarray(d["img1"]), jnp.asarray(sorg), S, "interpret")
    Cx, Cy, _ = jkc._surfaces_for_norm(spatch, jq, P, norm)
    sc = d["sc"].numpy()
    frozen = d["frozen"].numpy()
    want = np.asarray(jkc._run_iterations(Cx, Cy, None, jq, jnp.asarray(sc[:, 5:7]), jnp.asarray(frozen),
                                          ITERS, EPS, S, P, "interpret"))
    got = kc.lk_corr_align(torch.as_tensor(d["img1"]), d["org"], S, d["gx"], d["gy"], d["sc"], ITERS, EPS,
                           float(S - P - 1)).numpy()
    assert np.abs(got - want)[~frozen].max() <= PT_TOL
    np.testing.assert_array_equal(got[frozen], sc[frozen, 5:7])


def test_image_index_stack_equals_separate_calls():
    """A (2, H, W) stack with a per-window image index gives what two
    separate calls give, for both wrappers."""
    a, b = _problem(5, 24, 120, 188, "none"), _problem(6, 24, 120, 188, "none")
    S, hi = a["S"], float(a["S"] - P - 1)
    imgs = torch.stack([torch.as_tensor(a["img1"]), torch.as_tensor(b["img1"])])
    index = torch.tensor([0] * 24 + [1] * 24, dtype=torch.int32)
    cat = {k: torch.cat([a[k], b[k]]) for k in ("org", "gx", "gy", "sc")}
    got = kc.lk_corr_align(imgs, cat["org"], S, cat["gx"], cat["gy"], cat["sc"], ITERS, EPS, hi, img_index=index)
    one = kc.lk_corr_align(imgs[0], a["org"], S, a["gx"], a["gy"], a["sc"], ITERS, EPS, hi)
    two = kc.lk_corr_align(imgs[1], b["org"], S, b["gx"], b["gy"], b["sc"], ITERS, EPS, hi)
    assert torch.equal(got, torch.cat([one, two]))
    pts = torch.as_tensor(np.concatenate([a["pts"], b["pts"]]))
    tmpl = kc.extract_template(imgs, pts, P, index)
    assert torch.equal(tmpl[:24], kc.extract_template(imgs[0], pts[:24], P))
    assert torch.equal(tmpl[24:], kc.extract_template(imgs[1], pts[24:], P))


def _k2_blend_template(img, pts, P):
    """The template formula as the tracker ran it before extract_template:
    clipped (P+3) window origins, K2, four bilinear slices."""
    H, W = img.shape
    q, Tq = P + 2, P + 3
    torg = kc._clip_xy(torch.floor(pts) - (P + 1) // 2, 0.0, W - Tq, H - Tq)
    tpatch = extract_windows(img, torg.to(torch.int32), Tq)
    a = torch.clamp(pts - (P + 1) / 2.0 - torg, 0.0, 1.0)
    ax = a[:, 0][:, None, None]
    ay = a[:, 1][:, None, None]
    return (
        tpatch[:, :q, :q] * (1 - ax) * (1 - ay)
        + tpatch[:, :q, 1 : q + 1] * ax * (1 - ay)
        + tpatch[:, 1 : q + 1, :q] * (1 - ax) * ay
        + tpatch[:, 1 : q + 1, 1 : q + 1] * ax * ay
    )


@pytest.mark.parametrize("HW", [(60, 94), (120, 188)])
def test_template_reference_is_the_k2_blend_formula(HW):
    """Bit for bit, including points at and past the image edges, whose
    window origins and offsets clamp; and within 1e-4 of the JAX package's
    interpret path."""
    H, W = HW
    img = torch.as_tensor(_texture(7, H, W))
    rng = np.random.default_rng(8)
    pts = np.stack([rng.uniform(0, W - 1, 40), rng.uniform(0, H - 1, 40)], 1)
    pts[:8] = [[0, 0], [W - 1, H - 1], [-3.2, 5.5], [W + 2.7, H / 2], [0.4, H - 0.6], [W - 1.5, 0.25],
               [8.0, 8.0], [W - 9.5, H - 9.5]]
    pts = torch.as_tensor(pts.astype(np.float32))
    got = kc.extract_template(img, pts, P)
    assert torch.equal(got, _k2_blend_template(img, pts, P))
    assert torch.equal(got, kc.extract_template_reference(img, pts, P))
    jsp = jkc._interp_template(jnp.asarray(img.numpy()), jnp.asarray(pts.numpy()), P, "interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(jsp), atol=1e-4)


def test_wrappers_reject_bad_input_before_dispatch():
    """Shape, hi and shared-memory checks come before the device dispatch:
    meta tensors (no data, no kernel) raise the shape error, not an
    unsupported-device one."""
    m = dict(device="meta")
    img = torch.zeros((60, 94), **m)
    org = torch.zeros((4, 2), dtype=torch.int32, **m)
    g = torch.zeros((4, P, P), **m)
    sc = torch.zeros((4, 8), **m)
    S, hi = 35, 19.0
    cases = [
        (dict(sc=torch.zeros((4, 7), **m)), "sc"),
        (dict(gx=torch.zeros((4, P, P + 1), **m)), "filters"),
        (dict(gy=torch.zeros((3, P, P), **m)), "filters"),
        (dict(hi=20.0), "hi="),
        (dict(hi=-0.5), "hi="),
        (dict(img=torch.zeros((200, 200), **m), S=112, gx=torch.zeros((4, 7, 7), **m),
              gy=torch.zeros((4, 7, 7), **m), hi=100.0), "48 KB"),
        (dict(S=P), "window"),
        (dict(img=torch.zeros((2, 60, 94), **m)), "img_index"),
        (dict(surfaces_out=torch.zeros((4, 2, 20, 20), **m)), "surfaces_out"),
    ]
    for change, msg in cases:
        kw = dict(img=img, origins=org, S=S, gx=g, gy=g, sc=sc, iters=ITERS, eps=EPS, hi=hi)
        kw.update(change)
        with pytest.raises(ValueError, match=msg):
            kc.lk_corr_align(**kw)
    with pytest.raises(ValueError, match="unsupported device"):
        kc.lk_corr_align(img, org, S, g, g, sc, ITERS, EPS, hi)
    with pytest.raises(ValueError, match="pts"):
        kc.extract_template(img, torch.zeros((4, 3), **m), P)
    with pytest.raises(ValueError, match="does not fit"):
        kc.extract_template(img, torch.zeros((4, 2), **m), 58)
    with pytest.raises(ValueError, match="img_index"):
        kc.extract_template(torch.zeros((2, 60, 94), **m), torch.zeros((4, 2), **m), P)
    with pytest.raises(ValueError, match="unsupported device"):
        kc.extract_template(img, torch.zeros((4, 2), **m), P)


def test_window_sectors_hand_counted():
    """A 16-wide float32 image has two 32-byte sectors a row.  A 3x3 window
    at (7, 0) covers pixels 7-9 of rows 0-2, which straddle each row's two
    sectors: 6.  A second window at (0, 0) adds none (sectors 0, 2, 4);
    a third at (13, 1) adds rows 1-3's second sectors, of which row 3's
    (sector 7) is new; an origin past the edge clamps to (13, 5): rows 5-7,
    3 more; image 1 of a stack starts 8 rows (16 sectors) later."""
    assert window_sectors([[7, 0]], 3, 8, 16) == 6
    assert window_sectors([[7, 0], [0, 0]], 3, 8, 16) == 6
    assert window_sectors([[7, 0], [0, 0], [13, 1]], 3, 8, 16) == 7
    assert window_sectors([[7, 0], [0, 0], [13, 1], [40, 9]], 3, 8, 16) == 10
    assert window_sectors([[7, 0], [7, 0]], 3, 8, 16, img_index=[0, 1]) == 12
    # A whole 8-pixel-aligned row of 8 pixels is one sector.
    assert window_sectors([[8, 0]], 8, 8, 16) == 8


def test_footprint_sectors_hand_counted():
    """(S, P) = (4, 2), so K = 3 and each surface cell reads a 2x2 block of
    a 16-wide image (two 32-byte sectors a row).  Lane 0's window sits at
    (6, 0): cell (y, x) = (0, 0) reads pixels 6-7 of rows 0-1, one sector a
    row: 2; cell (0, 1) reads pixels 7-8, which straddle both sectors of
    rows 0-1: 4 in all; cell (1, 0) adds row 2's first sector: 5.  Lane 1's
    origin (20, 9) clamps to (12, 4); its cell (2, 2), flat index
    (1 * 3 + 2) * 3 + 2 = 17, reads pixels 14-15 of rows 6-7: 2 more."""
    org = [[6, 0], [20, 9]]
    assert footprint_sectors(org, [0], 4, 2, 8, 16) == 2
    assert footprint_sectors(org, [0, 1], 4, 2, 8, 16) == 4
    assert footprint_sectors(org, [0, 1, 3], 4, 2, 8, 16) == 5
    assert footprint_sectors(org, [0, 1, 3, 17], 4, 2, 8, 16) == 7
    # The footprints of all K*K cells of a window are the window itself.
    assert footprint_sectors(org[:1], range(9), 4, 2, 8, 16) == window_sectors(org[:1], 4, 8, 16)


def test_empty_calls_count_no_launch():
    """A call with no windows or features returns an empty result on any
    device and counts no launch: the kernels launch nothing for it.  Meta
    tensors stand in for a device, which the wrappers otherwise refuse."""
    before = dict(_cuda.launch_counts)
    m = dict(device="meta")
    img = torch.zeros((60, 94), **m)
    org = torch.zeros((0, 2), dtype=torch.int32, **m)
    g = torch.zeros((0, P, P), **m)
    assert kc.lk_corr_align(img, org, 35, g, g, torch.zeros((0, 8), **m), ITERS, EPS, 19.0).shape == (0, 2)
    assert kc.extract_template(img, torch.zeros((0, 2), **m), P).shape == (0, P + 2, P + 2)
    assert extract_windows(img, org, 18).shape == (0, 18, 18)
    c = torch.zeros((0, 21, 21), **m)
    assert kc.lk_corr_iterate(torch.zeros((0, 8), **m), c, c, ITERS, EPS, 19.0).shape == (0, 2)
    assert kc.lk_corr_iterate_gain(torch.zeros((0, 12), **m), c, c, c, ITERS, EPS, 19.0).shape == (0, 2)
    assert _cuda.launch_counts == before


def test_plain_versions_count_no_launch():
    before = dict(_cuda.launch_counts)
    d = _problem(9, 8, 60, 94, "none")
    img1 = torch.as_tensor(d["img1"])
    kc.lk_corr_align(img1, d["org"], d["S"], d["gx"], d["gy"], d["sc"], ITERS, EPS, float(d["S"] - P - 1))
    kc.lk_corr_align_reference(img1, d["org"], d["S"], d["gx"], d["gy"], d["sc"], ITERS, EPS, float(d["S"] - P - 1))
    kc.extract_template(img1, torch.as_tensor(d["pts"]), P)
    kc.extract_template_reference(img1, torch.as_tensor(d["pts"]), P)
    assert _cuda.launch_counts == before
