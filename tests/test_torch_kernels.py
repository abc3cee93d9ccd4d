"""The port's twelve hand-written CUDA kernels, their wrappers and their
plain versions.

The tests marked ``cuda`` hold each kernel against its plain version on the
card and skip without one; the rest run anywhere.  This file imports neither
JAX nor the JAX package, so on the machine with the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(the JAX parity of the plain versions is in test_torch_patch_extract.py,
test_torch_klt_corr.py, test_torch_lk_align.py and
test_torch_lk_align_gain.py)."""
import numpy as np
import pytest
import torch

import chip_smoke
from _lm_cases import LM_F64_WIDEST_M, LM_POS_TOL, lm_hold, lm_kernel_calls, lm_pool, lm_problem
from chip_smoke import lk_trace
from msckf_stereo_c_torch.config import matmul_precision_scope
from msckf_stereo_c_torch.ops import _cuda
from msckf_stereo_c_torch.ops import fast as tfast
from msckf_stereo_c_torch.ops import klt_corr as kc
from msckf_stereo_c_torch.ops.patch_extract import extract_windows, extract_windows_reference

torch.set_num_threads(1)

P, ITERS, EPS = 15, 30, 0.01
S = P + 2 * kc._SEARCH_RADIUS + 2
HI = float(S - P - 1)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _texture(seed, H, W):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 255, (H // 6 + 1, W // 6 + 1)), np.ones((6, 6)))[:H, :W]
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), axis, img)
    return img.astype(np.float32)


def _lk_problem(seed, N, H=240, W=320, shift=(2.6, -1.9), device="cpu"):
    """(sc, Cx, Cy, good) of N features of a texture tracked into a shifted
    copy of it, built with the port's own template and surface code."""
    img0 = _texture(seed, H, W)
    img1 = np.roll(img0, (round(shift[1]), round(shift[0])), (0, 1))
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1).astype(np.float32)
    a, b = (torch.as_tensor(x, device=device) for x in (img0, img1))
    pts = torch.as_tensor(pts, device=device)
    tq = kc._template_quantities(kc.extract_template(a, pts, P), P)
    sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
    Cx, Cy = kc._corr_surfaces(extract_windows(b, sorg.to(torch.int32), S), tq.gx, tq.gy, P)
    frozen = ~tq.good
    frozen[::9] = True
    return kc._k1_sc(tq, pts - (P - 1) / 2.0 - sorg, frozen), Cx, Cy, ~frozen


def _gain_problem(seed, N, norm, H=240, W=320, device="cpu"):
    """(sc, Cx, Cy, Ct, live) of K3 for N features tracked into a shifted,
    gain- and offset-changed copy of a texture, under ``norm`` ('gain' or
    'offset'), built with the port's own template and surface code."""
    img0 = _texture(seed, H, W)
    img1 = 1.2 * np.roll(img0, (-2, 3), (0, 1)) - 10.0
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1).astype(np.float32)
    a, b = (torch.as_tensor(x.astype(np.float32), device=device) for x in (img0, img1))
    pts = torch.as_tensor(pts, device=device)
    tq = kc._template_quantities(kc.extract_template(a, pts, P), P, norm)
    sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
    Cx, Cy, Ct = kc._surfaces_for_norm(extract_windows(b, sorg.to(torch.int32), S), tq, P, norm)
    frozen = ~tq.good
    frozen[::9] = True
    return kc._k3_sc(tq, pts - (P - 1) / 2.0 - sorg, frozen), Cx, Cy, Ct, ~frozen


def _align_problem(seed, N, norm="none", H=240, W=320, device="cpu"):
    """(img1, origins, S, gx, gy, sc, live) of lk_corr_align for N features
    of a texture tracked into a shifted copy of it under ``norm`` ('none'
    or 'zeromean'), built as the main path builds them."""
    img0 = _texture(seed, H, W)
    img1 = np.roll(img0, (2, -3), (0, 1)) + 7.0
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1).astype(np.float32)
    a, b = (torch.as_tensor(x, device=device) for x in (img0, img1))
    pts = torch.as_tensor(pts, device=device)
    tq = kc._template_quantities(kc.extract_template(a, pts, P), P, norm)
    S_ = min(S, H, W)
    sorg = kc._clip_xy(torch.floor(pts) - S_ // 2, 0.0, W - S_, H - S_)
    gx, gy = (tq.gx, tq.gy) if norm == "none" else kc._centred_filters(tq, P)
    frozen = ~tq.good
    frozen[::9] = True
    sc = kc._k1_sc(tq, pts - (P - 1) / 2.0 - sorg, frozen)
    return b, sorg.to(torch.int32), S_, gx, gy, sc, ~frozen


def _align_gain_problem(seed, N, norm, H=240, W=320, device="cpu"):
    """(img1, origins, S, gx, gy, gt, sc, live) of lk_corr_align_gain for N
    features of a texture tracked into a shifted, gain- and offset-changed
    copy of it under ``norm`` ('gain' or 'offset'), built as the main path
    builds them."""
    img0 = _texture(seed, H, W)
    img1 = 1.2 * np.roll(img0, (-2, 3), (0, 1)) - 10.0
    rng = np.random.default_rng(seed + 1)
    pts = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1).astype(np.float32)
    a, b = (torch.as_tensor(x.astype(np.float32), device=device) for x in (img0, img1))
    pts = torch.as_tensor(pts, device=device)
    tq = kc._template_quantities(kc.extract_template(a, pts, P), P, norm)
    S_ = min(S, H, W)
    sorg = kc._clip_xy(torch.floor(pts) - S_ // 2, 0.0, W - S_, H - S_)
    frozen = ~tq.good
    frozen[::9] = True
    sc = kc._k3_sc(tq, pts - (P - 1) / 2.0 - sorg, frozen)
    return (b, sorg.to(torch.int32), S_, *kc._filters_for_norm(tq, P, norm), sc, ~frozen)


def _resample_inputs(H, W, n, seed, device="cpu"):
    """(pts, origins, Sb) of n resample_template lanes of the fused call's
    geometry on an H x W image: forward results up to 9 px from their
    block centres, the first six offsets clamping at both ends of [0,
    Sb - (P+3)] or sitting on them."""
    rng = np.random.default_rng(seed)
    S_ = min(S, H, W)
    Sb = S_ + 2
    guess = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    o1 = np.clip(np.floor(guess) - S_ // 2 - 1, 0, [W - Sb, H - Sb])
    pts = guess + rng.uniform(-9, 9, (n, 2))
    top = Sb - (P + 3)
    pts[:6] = o1[:6] + (P + 1) / 2.0 + np.array(
        [[-2.5, -0.3], [top + 1.7, top + 0.2], [0, top], [3, 5], [4.75, 0.5], [top - 0.25, 1 - 2.0**-14]])
    return (torch.as_tensor(pts.astype(np.float32), device=device),
            torch.as_tensor(o1.astype(np.int32), device=device), Sb)


def _edge_points(H, W, n, seed, device="cpu"):
    """n points across an H x W image, the first six at and past its edges."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    pts[:6] = [[0, 0], [W - 1, H - 1], [-3.2, 5.5], [W + 2.7, H / 2], [0.4, H - 0.6], [W - 1.5, 0.25]]
    return torch.as_tensor(pts.astype(np.float32), device=device)


def test_four_taps_give_the_plain_loop():
    """The tent weights are non-zero only on the 2x2 cells around f, and a
    frozen lane never moves: the kernel's per-lane four-tap loop gives the
    plain version's full K*K sum with a batch-wide exit, within 2 * eps
    (a lane may freeze one sub-eps step apart)."""
    sc, Cx, Cy, live = _lk_problem(0, 64)
    want = kc.lk_corr_iterate(sc, Cx, Cy, ITERS, EPS, HI).numpy()
    got, _, _, _ = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy()), ITERS, EPS, HI)
    assert live.sum() > 40
    np.testing.assert_allclose(got[live.numpy()], want[live.numpy()], rtol=0, atol=2 * EPS)
    np.testing.assert_array_equal(want[~live.numpy()], sc[~live, 5:7].numpy())


def test_k1_trace_counts_the_sectors_the_steps_read():
    """A lane frozen at the start takes no step and reads no surface; each
    step reads two rows of 2x2 cells, so one to two 32-byte sectors per row,
    and a lane that steps reads at least its two rows' sectors: far less
    than the whole surfaces."""
    sc, Cx, Cy, live = _lk_problem(2, 40)
    _, steps, sectors, _ = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy()), ITERS, EPS, HI)
    assert (steps[~live.numpy()] == 0).all() and (steps[live.numpy()] > 0).all()
    assert 2 * int(live.sum()) <= sectors <= 4 * int(steps.sum())
    assert sectors * 32 < 0.25 * Cx.numel() * 4


@pytest.mark.parametrize("norm", ["gain", "offset"])
def test_four_taps_give_the_plain_gain_loop(norm):
    """K3's per-lane four-tap loop on three surfaces gives the plain
    version's full K*K sums with a batch-wide exit, within 2 * eps, and a
    frozen lane keeps its start point."""
    sc, Cx, Cy, Ct, live = _gain_problem(4, 64, norm)
    want = kc.lk_corr_iterate_gain(sc, Cx, Cy, Ct, ITERS, EPS, HI).numpy()
    got, steps, sectors, _ = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy(), Ct.numpy()), ITERS, EPS, HI)
    assert live.sum() > 40
    np.testing.assert_allclose(got[live.numpy()], want[live.numpy()], rtol=0, atol=2 * EPS)
    np.testing.assert_array_equal(want[~live.numpy()], sc[~live, 9:11].numpy())
    assert (steps[~live.numpy()] == 0).all() and sectors * 32 < 0.25 * Cx.numel() * 4


def test_plain_extract_windows_clamps_the_image_index():
    """Out-of-range image indices take the nearest image, as the kernel
    clamps them."""
    imgs = torch.arange(3 * 20 * 30, dtype=torch.float32).reshape(3, 20, 30)
    org = torch.tensor([[2, 3]] * 4, dtype=torch.int32)
    got = extract_windows(imgs, org, 8, torch.tensor([-4, 0, 2, 9], dtype=torch.int32))
    for n, b in enumerate((0, 0, 2, 2)):
        assert torch.equal(got[n], imgs[b, 3:11, 2:10])


def test_plain_versions_count_no_launch():
    before = dict(_cuda.launch_counts)
    sc, Cx, Cy, _ = _lk_problem(1, 8)
    kc.lk_corr_iterate(sc, Cx, Cy, ITERS, EPS, HI)
    g = _gain_problem(1, 8, "gain")
    kc.lk_corr_iterate_gain(*g[:4], ITERS, EPS, HI)
    extract_windows(torch.zeros((60, 94)), torch.zeros((3, 2), dtype=torch.int32), 18)
    assert _cuda.launch_counts == before


def test_wrappers_reject_bad_input():
    img = torch.zeros((60, 94))
    with pytest.raises(ValueError):
        extract_windows(img, torch.zeros((4, 3), dtype=torch.int32), 18)
    with pytest.raises(ValueError):
        extract_windows(img, torch.zeros((4, 2), dtype=torch.int32), 61)
    with pytest.raises(ValueError):
        extract_windows(torch.zeros((2, 60, 94)), torch.zeros((4, 2), dtype=torch.int32), 18)
    C = torch.zeros((3, 21, 21))
    with pytest.raises(ValueError):
        kc.lk_corr_iterate(torch.zeros((3, 8)), C, C, ITERS, EPS, 20.0)
    with pytest.raises(ValueError):
        kc.lk_corr_iterate(torch.zeros((3, 7)), C, C, ITERS, EPS, HI)
    with pytest.raises(ValueError):
        kc.lk_corr_iterate_gain(torch.zeros((3, 12)), C, C, C, ITERS, EPS, 20.0)
    with pytest.raises(ValueError):
        kc.lk_corr_iterate_gain(torch.zeros((3, 8)), C, C, C, ITERS, EPS, HI)
    with pytest.raises(ValueError):
        kc.lk_corr_iterate_gain(torch.zeros((3, 12)), C, C, torch.zeros((3, 20, 20)), ITERS, EPS, HI)


@pytest.mark.cuda
@pytest.mark.parametrize("S_win", [18, 35, 37])
def test_extract_windows_kernel_matches_plain(cuda_device, S_win):
    """Bit-exact on the four pyramid level sizes of the main path, with
    origins at and past the clip limits (the kernel clamps them)."""
    rng = np.random.default_rng(3)
    for H, W in [(480, 752), (240, 376), (120, 188), (60, 94)]:
        img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=cuda_device)
        org = np.stack([rng.integers(0, W - S_win + 1, 144), rng.integers(0, H - S_win + 1, 144)], 1)
        org[:6] = [[0, 0], [W - S_win, H - S_win], [-9, H], [W + 3, -1], [-1, -1], [W, 0]]
        org_t = torch.as_tensor(org.astype(np.int32), device=cuda_device)
        before = _cuda.launch_counts["extract_windows"]
        got = extract_windows(img, org_t, S_win)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["extract_windows"] == before + 1
        assert torch.equal(got, extract_windows_reference(img, org_t, S_win))


@pytest.mark.cuda
def test_extract_windows_kernel_image_index(cuda_device):
    imgs = torch.rand((3, 120, 188), device=cuda_device) * 255
    org = torch.randint(0, 100, (30, 2), dtype=torch.int32, device=cuda_device)
    index = torch.randint(0, 3, (30,), dtype=torch.int32, device=cuda_device)
    got = extract_windows(imgs, org, 18, index)
    assert torch.equal(got, extract_windows_reference(imgs, org, 18, index))


@pytest.mark.cuda
def test_extract_windows_kernel_clamps_the_image_index(cuda_device):
    """An index below 0 or of B or more reads the nearest image, not memory
    outside the stack."""
    imgs = torch.rand((3, 120, 188), device=cuda_device) * 255
    org = torch.randint(0, 100, (6, 2), dtype=torch.int32, device=cuda_device)
    index = torch.tensor([-1, -1000, 3, 1 << 30, 0, 2], dtype=torch.int32, device=cuda_device)
    got = extract_windows(imgs, org, 18, index)
    assert torch.equal(got, extract_windows_reference(imgs, org, 18, index))
    assert torch.equal(got[:2], extract_windows_reference(imgs, org[:2], 18, torch.zeros_like(index[:2])))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [48, 96, 144])
def test_lk_corr_iterate_kernel_matches_plain(cuda_device, N):
    """Valid lanes within 2 * eps of the plain version; frozen lanes keep
    their start point exactly."""
    sc, Cx, Cy, live = _lk_problem(N, N, H=480, W=752, device=cuda_device)
    before = _cuda.launch_counts["lk_corr_iterate"]
    got = kc.lk_corr_iterate(sc, Cx, Cy, ITERS, EPS, HI)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["lk_corr_iterate"] == before + 1
    want = kc.lk_corr_iterate_reference(sc, Cx, Cy, ITERS, EPS, HI)
    assert torch.isfinite(got).all()
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 5:7])


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["gain", "offset"])
@pytest.mark.parametrize("N", [48, 96, 144])
def test_lk_corr_iterate_gain_kernel_matches_plain(cuda_device, N, norm):
    """K3 on the card: valid lanes within 2 * eps of the plain version on
    strided views of one (N, 3, K, K) surface tensor; frozen lanes keep
    their start point exactly."""
    sc, Cx, Cy, Ct, live = _gain_problem(N, N, norm, H=480, W=752, device=cuda_device)
    assert Cx.stride(0) == 3 * Cx.shape[-1] ** 2
    before = _cuda.launch_counts["lk_corr_iterate_gain"]
    got = kc.lk_corr_iterate_gain(sc, Cx, Cy, Ct, ITERS, EPS, HI)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["lk_corr_iterate_gain"] == before + 1
    want = kc.lk_corr_iterate_gain_reference(sc, Cx, Cy, Ct, ITERS, EPS, HI)
    assert torch.isfinite(got).all()
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 9:11])


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["none", "zeromean"])
@pytest.mark.parametrize("N,H,W", [(48, 480, 752), (96, 480, 752), (144, 480, 752), (48, 60, 94)])
def test_lk_corr_align_kernel_matches_plain(cuda_device, N, H, W, norm):
    """Surfaces within 1e-5 x max|C| of the plain version's conv2d (full
    f32, as the main path runs it); valid lanes within 2 * eps; frozen
    lanes keep their start point exactly.  W = 94 takes the 4-byte window
    copies, the others the 16-byte ones."""
    img, org, S_, gx, gy, sc, live = _align_problem(N, N, norm, H, W, device=cuda_device)
    K = S_ - P + 1
    surf = torch.empty((N, 2, K, K), device=cuda_device)
    surf_ref = torch.empty_like(surf)
    args = (img, org, S_, gx, gy, sc, ITERS, EPS, float(K - 2))
    before = _cuda.launch_counts["lk_corr_align"]
    got = kc.lk_corr_align(*args, surfaces_out=surf)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["lk_corr_align"] == before + 1
    with matmul_precision_scope("tensorfloat32"):
        want = kc.lk_corr_align_reference(*args, surfaces_out=surf_ref)
    assert float((surf - surf_ref).abs().max()) <= 1e-5 * float(surf_ref.abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 5:7])
    # Without the surfaces output a frozen lane skips its window: same result.
    assert torch.equal(kc.lk_corr_align(*args), got)


@pytest.mark.cuda
def test_lk_corr_align_kernel_image_index(cuda_device):
    """A (2, H, W) stack with a per-window image index gives each image's
    own result."""
    a = _align_problem(5, 40, H=240, W=376, device=cuda_device)
    b = _align_problem(6, 40, H=240, W=376, device=cuda_device)
    imgs = torch.stack([a[0], b[0]])
    index = torch.tensor([0] * 40 + [1] * 40, dtype=torch.int32, device=cuda_device)
    org, gx, gy, sc = (torch.cat([a[i], b[i]]) for i in (1, 3, 4, 5))
    hi = float(a[2] - P - 1)
    got = kc.lk_corr_align(imgs, org, a[2], gx, gy, sc, ITERS, EPS, hi, img_index=index)
    one = kc.lk_corr_align(a[0], *a[1:6], ITERS, EPS, hi)
    two = kc.lk_corr_align(b[0], *b[1:6], ITERS, EPS, hi)
    assert torch.equal(got, torch.cat([one, two]))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["gain", "offset"])
@pytest.mark.parametrize("N,H,W", [(48, 480, 752), (96, 480, 752), (144, 480, 752), (48, 60, 94)])
def test_lk_corr_align_gain_kernel_matches_plain(cuda_device, N, H, W, norm):
    """Each of the three surfaces within 1e-5 x its own max|C| of the plain
    version's conv2d (full f32, as the main path runs it; 'gain''s Ct
    correlates a zero-mean template); valid lanes within 2 * eps; frozen
    lanes keep their start point exactly.  W = 94 takes the 4-byte window
    copies, the others the 16-byte ones."""
    img, org, S_, gx, gy, gt, sc, live = _align_gain_problem(N, N, norm, H, W, device=cuda_device)
    K = S_ - P + 1
    surf = torch.empty((N, 3, K, K), device=cuda_device)
    surf_ref = torch.empty_like(surf)
    args = (img, org, S_, gx, gy, gt, sc, ITERS, EPS, float(K - 2))
    before = _cuda.launch_counts["lk_corr_align_gain"]
    got = kc.lk_corr_align_gain(*args, surfaces_out=surf)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["lk_corr_align_gain"] == before + 1
    with matmul_precision_scope("tensorfloat32"):
        want = kc.lk_corr_align_gain_reference(*args, surfaces_out=surf_ref)
    for i in range(3):
        assert float((surf[:, i] - surf_ref[:, i]).abs().max()) <= 1e-5 * float(surf_ref[:, i].abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 9:11])
    # Without the surfaces output a frozen lane skips its window: same result.
    assert torch.equal(kc.lk_corr_align_gain(*args), got)


@pytest.mark.cuda
def test_lk_corr_align_gain_kernel_image_index(cuda_device):
    """A (2, H, W) stack with a per-feature image index gives each image's
    own result."""
    a = _align_gain_problem(5, 40, "gain", H=240, W=376, device=cuda_device)
    b = _align_gain_problem(6, 40, "gain", H=240, W=376, device=cuda_device)
    imgs = torch.stack([a[0], b[0]])
    index = torch.tensor([0] * 40 + [1] * 40, dtype=torch.int32, device=cuda_device)
    org, gx, gy, gt, sc = (torch.cat([a[i], b[i]]) for i in (1, 3, 4, 5, 6))
    hi = float(a[2] - P - 1)
    got = kc.lk_corr_align_gain(imgs, org, a[2], gx, gy, gt, sc, ITERS, EPS, hi, img_index=index)
    one = kc.lk_corr_align_gain(a[0], *a[1:7], ITERS, EPS, hi)
    two = kc.lk_corr_align_gain(b[0], *b[1:7], ITERS, EPS, hi)
    assert torch.equal(got, torch.cat([one, two]))


@pytest.mark.cuda
def test_resample_template_kernel_matches_plain(cuda_device):
    """Within 2e-6 x max|sp_b| of the plain tent-weight einsum (a batched
    GEMM whose association is not specified) and the same quality gate, on
    the four pyramid level sizes, with offsets clamping at both ends."""
    rng = np.random.default_rng(5)
    for H, W in [(480, 752), (240, 376), (120, 188), (60, 94)]:
        img = torch.as_tensor(_texture(int(rng.integers(1000)), H, W), device=cuda_device)
        pts, org, Sb = _resample_inputs(H, W, 144, H, device=cuda_device)
        before = _cuda.launch_counts["resample_template"]
        got = kc.resample_template(img, pts, org, Sb, P)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["resample_template"] == before + 1
        with matmul_precision_scope("tensorfloat32"):
            want = kc.resample_template_reference(img, pts, org, Sb, P)
            assert torch.equal(kc._template_quantities(got, P).good, kc._template_quantities(want, P).good)
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
        # The einsum's layout, so reductions downstream sum in the same order.
        assert got.stride() == want.stride()


@pytest.mark.cuda
def test_resample_template_kernel_image_index(cuda_device):
    imgs = torch.rand((3, 120, 188), device=cuda_device) * 255
    pts, org, Sb = _resample_inputs(120, 188, 30, 2, device=cuda_device)
    index = torch.tensor([-1, 5] + [0, 1, 2] * 9 + [2], dtype=torch.int32, device=cuda_device)
    got = kc.resample_template(imgs, pts, org, Sb, P, index)
    with matmul_precision_scope("tensorfloat32"):
        want = kc.resample_template_reference(imgs, pts, org, Sb, P, index)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("N,H,W", [(144, 480, 752), (48, 60, 94)])
def test_lk_corr_align_kernel_passes_match_plain(cuda_device, N, H, W, passes):
    """The bf16 passes of the surface phase: surfaces within 1e-5 x max|C|
    of the plain version's (its bf16 GEMMs of the unfolded windows); valid
    lanes within 2 * eps of the plain loop run on the kernel's own
    surfaces (the GEMMs sum in another order, and a lane near a degenerate
    step may take another path on surfaces a rounding apart); frozen lanes
    unmoved; the scope's pass count is the wrapper's default."""
    img, org, S_, gx, gy, sc, live = _align_problem(N, N, "none", H, W, device=cuda_device)
    K = S_ - P + 1
    surf = torch.empty((N, 2, K, K), device=cuda_device)
    surf_ref = torch.empty_like(surf)
    args = (img, org, S_, gx, gy, sc, ITERS, EPS, float(K - 2))
    got = kc.lk_corr_align(*args, surfaces_out=surf, passes=passes)
    kc.lk_corr_align_reference(*args, surfaces_out=surf_ref, passes=passes)
    want = kc.lk_corr_iterate_reference(sc, surf[:, 0], surf[:, 1], ITERS, EPS, float(K - 2))
    torch.cuda.synchronize()
    assert float((surf - surf_ref).abs().max()) <= 1e-5 * float(surf_ref.abs().max())
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 5:7])
    with matmul_precision_scope("bfloat16" if passes == 1 else "bfloat16_3x"):
        assert torch.equal(kc.lk_corr_align(*args), kc.lk_corr_align(*args, passes=passes))
    f32 = torch.empty_like(surf)
    kc.lk_corr_align(*args, surfaces_out=f32, passes=0)
    assert not torch.equal(f32, surf)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("norm", ["gain", "offset"])
def test_lk_corr_align_gain_kernel_passes_match_plain(cuda_device, norm, passes):
    """As above for the three surfaces of 'gain' and 'offset', N=144 at
    752x480, the loop the affine-photometric one."""
    img, org, S_, gx, gy, gt, sc, live = _align_gain_problem(144, 144, norm, 480, 752, device=cuda_device)
    K = S_ - P + 1
    surf = torch.empty((144, 3, K, K), device=cuda_device)
    surf_ref = torch.empty_like(surf)
    args = (img, org, S_, gx, gy, gt, sc, ITERS, EPS, float(K - 2))
    got = kc.lk_corr_align_gain(*args, surfaces_out=surf, passes=passes)
    kc.lk_corr_align_gain_reference(*args, surfaces_out=surf_ref, passes=passes)
    want = kc.lk_corr_iterate_gain_reference(sc, surf[:, 0], surf[:, 1], surf[:, 2], ITERS, EPS, float(K - 2))
    torch.cuda.synchronize()
    for i in range(3):
        assert float((surf[:, i] - surf_ref[:, i]).abs().max()) <= 1e-5 * float(surf_ref[:, i].abs().max())
    assert float((got - want)[live].abs().max()) <= 2 * EPS
    assert torch.equal(got[~live], sc[~live, 9:11])


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_resample_template_kernel_passes_match_plain(cuda_device, passes):
    """The bf16 passes of the tent blend (weights and pixels rounded as the
    passes see them) within 2e-6 x max of the plain version, on the four
    pyramid level sizes."""
    rng = np.random.default_rng(6)
    for H, W in [(480, 752), (240, 376), (120, 188), (60, 94)]:
        img = torch.as_tensor(_texture(int(rng.integers(1000)), H, W), device=cuda_device)
        pts, org, Sb = _resample_inputs(H, W, 144, H + 1, device=cuda_device)
        got = kc.resample_template(img, pts, org, Sb, P, passes=passes)
        want = kc.resample_template_reference(img, pts, org, Sb, P, passes=passes)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
        assert got.stride() == want.stride()


@pytest.mark.cuda
def test_extract_template_kernel_matches_plain(cuda_device):
    """Bit-exact on the four pyramid level sizes of the main path, with
    points at and past the image edges (origins and offsets clamped)."""
    rng = np.random.default_rng(4)
    for H, W in [(480, 752), (240, 376), (120, 188), (60, 94)]:
        img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=cuda_device)
        pts = _edge_points(H, W, 144, H, device=cuda_device)
        before = _cuda.launch_counts["extract_template"]
        got = kc.extract_template(img, pts, P)
        torch.cuda.synchronize()
        assert _cuda.launch_counts["extract_template"] == before + 1
        assert torch.equal(got, kc.extract_template_reference(img, pts, P))


@pytest.mark.cuda
def test_launch_opens_its_kernel_span(cuda_device):
    """While a profiler records, a launch opens its ``kernel.<name>`` span,
    which the kernel's device event follows, and counts once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img = torch.as_tensor(_texture(5, 120, 188), device=cuda_device)
    pts = _edge_points(120, 188, 144, 120, device=cuda_device)
    kc.extract_template(img, pts, P)  # built and loaded outside the profile
    before = _cuda.launch_counts["extract_template"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kc.extract_template(img, pts, P)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.device_type() == DeviceType.CPU and e.name() == "kernel.extract_template"]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA and "extract_template_kernel" in e.name()]
    assert _cuda.launch_counts["extract_template"] == before + 1
    assert len(spans) == 1 and len(kernels) == 1
    assert kernels[0].start_ns() >= spans[0].start_ns()


@pytest.mark.cuda
def test_extract_template_kernel_image_index(cuda_device):
    imgs = torch.rand((3, 120, 188), device=cuda_device) * 255
    pts = _edge_points(120, 188, 30, 1, device=cuda_device)
    index = torch.tensor([-1, 5] + [0, 1, 2] * 9 + [2], dtype=torch.int32, device=cuda_device)
    got = kc.extract_template(imgs, pts, P, index)
    assert torch.equal(got, kc.extract_template_reference(imgs, pts, P, index))


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(cuda_device):
    """A CUDA tensor the kernel does not take raises; it is not handed to
    the plain version."""
    C = torch.zeros((3, 21, 21), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        kc.lk_corr_iterate(torch.zeros((3, 8), device=cuda_device, dtype=torch.float64), C, C, 30, 0.01, HI)
    with pytest.raises(TypeError):
        kc.lk_corr_iterate_gain(torch.zeros((3, 12), device=cuda_device, dtype=torch.float64), C, C, C,
                                30, 0.01, HI)
    with pytest.raises(TypeError):
        extract_windows(torch.zeros((60, 94), device=cuda_device, dtype=torch.float64),
                        torch.zeros((3, 2), dtype=torch.int32, device=cuda_device), 18)
    img64 = torch.zeros((60, 94), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError):
        kc.extract_template(img64, torch.zeros((3, 2), device=cuda_device, dtype=torch.float64), P)
    g = torch.zeros((3, P, P), device=cuda_device, dtype=torch.float64)
    org = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kc.lk_corr_align(img64, org, S, g, g, torch.zeros((3, 8), device=cuda_device, dtype=torch.float64),
                         30, 0.01, HI)
    with pytest.raises(TypeError):
        kc.lk_corr_align_gain(img64, org, S, g, g, g, torch.zeros((3, 12), device=cuda_device, dtype=torch.float64),
                              30, 0.01, HI)
    with pytest.raises(TypeError):
        kc.resample_template(img64, torch.zeros((3, 2), device=cuda_device, dtype=torch.float64), org, 37, P)


# The FAST kernel sums the 16 circle terms in circle order; the plain
# version's ``torch.sum`` may add them in another order, so scores agree to
# float32 rounding of a 16-term sum, not bit for bit.
FAST_RTOL = 1e-4


@pytest.fixture(scope="module")
def rendered_frames():
    """Three presmoothed 480x752 frames of the bench scene (float32)."""
    from msckf_stereo_c_torch.ops.pyramid import smooth5
    from msckf_stereo_c_torch.sim import make_circle_trajectory, make_wall_landmarks
    from msckf_stereo_c_torch.sim.render import render_stereo_sequence

    traj = make_circle_trajectory(duration=4.0)
    img0, _ = render_stereo_sequence(traj, make_wall_landmarks(num=600, radius=8.0, seed=1),
                                     np.array([300, 330, 360]), r_wall=8.0)
    return smooth5(torch.as_tensor(img0, dtype=torch.float32))


def _fast_images(kind, H, W, rendered):
    """(B, H, W) float32: 'rendered' one bench frame (a centre crop where
    smaller), 'random' three distinct smoothed random textures."""
    if kind == "rendered":
        y0, x0 = (480 - H) // 2, (752 - W) // 2
        return rendered[:1, y0 : y0 + H, x0 : x0 + W].contiguous()
    return torch.as_tensor(np.stack([_texture(s, H, W) for s in (11, 12, 13)]))


def _hold_fast(img, thr, cell, occupied, expect_no_ties):
    """The kernel against the plain version on one stack: the corner mask
    exactly and the score map within FAST_RTOL through ``score_out``; the
    cell picks equal except in cells whose top two plain scores lie within
    FAST_RTOL; one launch a call."""
    B, H, W = img.shape
    Gy, Gx = H // cell, W // cell
    score_out = torch.full_like(img, -1.0)
    before = _cuda.launch_counts["fast_grid_corners"]
    got = tfast.detect_grid_corners(img, thr, cell, occupied, score_out=score_out)
    assert _cuda.launch_counts["fast_grid_corners"] == before + 1
    want = tfast.detect_grid_corners_reference(img, thr, cell, occupied)
    smap = tfast.fast_score_map(img, thr)[:, : Gy * cell, : Gx * cell]
    kmap = score_out[:, : Gy * cell, : Gx * cell]
    torch.cuda.synchronize()
    assert torch.equal(kmap > 0, smap > 0)
    assert bool(((kmap - smap).abs() <= FAST_RTOL * smap).all())
    assert bool((score_out[:, Gy * cell :] == -1.0).all()) and bool((score_out[:, :, Gx * cell :] == -1.0).all())
    tiles = smap.reshape(B, Gy, cell, Gx, cell).transpose(2, 3).reshape(B, Gy * Gx, cell * cell)
    top = torch.topk(tiles, 2, dim=-1).values
    near = (top[..., 0] > 0) & (top[..., 0] - top[..., 1] <= FAST_RTOL * top[..., 0])
    same = (got.valid == want.valid) & (got.xy == want.xy).all(-1)
    assert bool((same | near).all()), f"{int((~same & ~near).sum())} cells differ outside near ties"
    assert torch.allclose(got.score, want.score, rtol=FAST_RTOL, atol=0)
    if expect_no_ties:
        assert int(near.sum()) == 0
    assert got.xy.shape == (B, Gy * Gx, 2) and got.valid.dtype == torch.bool
    assert int(want.valid.sum()) > 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("occupied", [False, True])
@pytest.mark.parametrize("thr", [7.0, 10.0])
@pytest.mark.parametrize("cell", [16, 8])
@pytest.mark.parametrize("H,W", [(480, 752), (100, 130)])
@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_fast_grid_corners_kernel_matches_plain(cuda_device, rendered_frames, kind, H, W, cell, thr, occupied):
    img = _fast_images(kind, H, W, rendered_frames).to(cuda_device)
    B = img.shape[0]
    occ = None
    if occupied:
        rng = np.random.default_rng(cell + int(thr))
        occ = torch.as_tensor(rng.uniform(size=(B, H // cell, W // cell)) < 0.3, device=cuda_device)
    _hold_fast(img, thr, cell, occ, expect_no_ties=kind == "rendered")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [4, 5, 12, 32, 40, 150])
def test_fast_grid_corners_kernel_other_cells(cuda_device, cell):
    """Cells of any size: narrow groups, one cell a block, and cells walked
    in several 32 x 128 sub-tiles; W not a multiple of 4 (scalar loads)."""
    img = torch.as_tensor(np.stack([_texture(s, 330, 461) for s in (3, 4)]), device=cuda_device)
    _hold_fast(img, 7.0, cell, None, expect_no_ties=False)


@pytest.mark.cuda
def test_fast_grid_corners_kernel_broadcast_stack(cuda_device, rendered_frames):
    """A broadcast stack is scored once, as one image, and each lane's
    ``occupied`` still applies."""
    one = rendered_frames[1].to(cuda_device)
    stack = one.expand(4, *one.shape)
    occ = torch.as_tensor(np.random.default_rng(2).uniform(size=(4, 30, 47)) < 0.3, device=cuda_device)
    before = _cuda.launch_counts["fast_grid_corners"]
    got = tfast.detect_grid_corners(stack, 7.0, 16, occ)
    assert _cuda.launch_counts["fast_grid_corners"] == before + 1
    want = tfast.detect_grid_corners_reference(one.expand(4, *one.shape).contiguous(), 7.0, 16, occ)
    assert torch.equal(got.valid, want.valid) and torch.equal(got.xy, want.xy)
    assert torch.allclose(got.score, want.score, rtol=FAST_RTOL, atol=0)


@pytest.mark.cuda
def test_fast_grid_corners_kernel_rejects_bad_input(cuda_device):
    img = torch.rand((2, 64, 80), device=cuda_device) * 255
    with pytest.raises(TypeError):
        tfast.detect_grid_corners(img.double(), 7.0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tfast.detect_grid_corners(img.transpose(-1, -2), 7.0, 16)
    with pytest.raises(ValueError, match="occupied"):
        tfast.detect_grid_corners(img, 7.0, 16, torch.zeros((2, 4, 4), dtype=torch.bool, device=cuda_device))
    with pytest.raises(TypeError):
        tfast.detect_grid_corners(img, 7.0, 16, torch.zeros((2, 4, 5), dtype=torch.uint8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lanes", [(torch.float32, 512), (torch.float64, 4)])
def test_qr_compress_kernel_matches_its_plain_version(cuda_device, dtype, lanes):
    """``qr_compress`` on the textbook update's stacked rows at the eval
    cell's (B, 2560, 142) (``chip_smoke.qr_problem``: 21 zero columns, tracks
    of 5-77 rows, zero padding, an empty lane 0), one launch: R upper
    triangular, R^T R within ``chip_smoke.QR_RTOL`` of A^T A and of the
    plain version's R^T R, the empty lane's R exactly 0."""
    from msckf_stereo_c_torch.ops import linalg as tlinalg

    A = chip_smoke.qr_problem(lanes, 32, 20, seed=lanes, dtype=dtype, device=cuda_device)
    before = _cuda.launch_counts["qr_compress"]
    R = tlinalg.qr_r(A)
    assert _cuda.launch_counts["qr_compress"] == before + 1
    assert R.shape == (lanes, 142, 142) and torch.equal(R, R.triu())
    rtol = chip_smoke.QR_RTOL[str(dtype).split(".")[-1]]
    assert float(chip_smoke.qr_gram_gap(A, R).max()) <= rtol
    plain = tlinalg.qr_r_reference(A).double()
    G = plain.transpose(-1, -2) @ plain
    gap = (R.double().transpose(-1, -2) @ R.double() - G).abs().amax((-2, -1))
    assert float((gap / G.abs().amax((-2, -1)).clamp_min(1e-300)).max()) <= rtol
    assert bool((R[0] == 0).all())


@pytest.mark.cuda
def test_qr_compress_kernel_spreads_nan_as_its_plain_version(cuda_device):
    """A NaN row, a single NaN entry in the last chunk and a NaN row in an
    otherwise empty lane each make that lane's R non-finite, as the plain
    version's; every other lane stays finite and within ``QR_RTOL``."""
    from msckf_stereo_c_torch.ops import linalg as tlinalg

    A = chip_smoke.qr_problem(6, 32, 20, seed=6, dtype=torch.float32)
    A[1, 3, :] = float("nan")
    A[2, 2500, 40] = float("nan")
    A[0, 70, :] = float("nan")
    plain = tlinalg.qr_r_reference(A)
    R = tlinalg.qr_r(A.to(cuda_device)).cpu()
    want = torch.isfinite(plain).flatten(1).all(-1)
    assert want.tolist() == [False, False, False, True, True, True]
    assert torch.equal(torch.isfinite(R).flatten(1).all(-1), want)
    assert float(chip_smoke.qr_gram_gap(A[3:], R[3:]).max()) <= chip_smoke.QR_RTOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lanes", [(torch.float32, 512), (torch.float64, 4)])
def test_qr_compress_kernel_counts_nonzero_rows_and_columns(cuda_device, dtype, lanes):
    """Under a profiler the kernel also writes each lane's rows and columns
    that hold a nonzero (or NaN) entry, at the eval cell's (B, 2560, 142),
    equal to a count in torch, into ``qr_work_log``; R is bit for bit the
    R of a launch that counts nothing."""
    from torch.profiler import ProfilerActivity, profile

    from msckf_stereo_c_torch.ops import linalg as tlinalg

    A = chip_smoke.qr_problem(lanes, 32, 20, seed=lanes + 1, dtype=dtype, device=cuda_device)
    A[1, 2559, 0] = float("nan")
    plain = tlinalg.qr_r(A)
    with profile(activities=[ProfilerActivity.CPU]):
        R = tlinalg.qr_r(A)
    W, elem = tlinalg.qr_work_log[-1]
    nz = A != 0
    want = torch.stack([nz.any(-1).sum(-1), nz.any(-2).sum(-1)], -1).to(torch.int32)
    assert W.device == A.device and elem == A.element_size()
    assert torch.equal(W, want)
    assert W[0].tolist() == [0, 0]
    assert torch.equal(R.nan_to_num(), plain.nan_to_num())


@pytest.mark.cuda
def test_qr_compress_kernel_rejects_bad_input(cuda_device):
    from msckf_stereo_c_torch.ops import linalg as tlinalg

    with pytest.raises(TypeError):
        tlinalg.qr_r(torch.zeros((2, 8, 4), dtype=torch.float16, device=cuda_device))
    with pytest.raises(ValueError, match="columns"):
        tlinalg.qr_r(torch.zeros((1, 8, 400), device=cuda_device))
    empty = tlinalg.qr_r(torch.zeros((0, 8, 4), device=cuda_device))
    assert empty.shape == (0, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,M", [(1, 20), (5, 20), (512, 20), (1, 40), (5, 40), (512, 40)])
def test_lm_triangulate_kernel_matches_its_plain_version(cuda_device, dtype, B, M):
    """``lm_triangulate`` against ``triangulate_tracks_reference`` on
    ``_lm_cases.lm_pool``'s window of at least 16,384 tracks (random invalid
    slots, tracks with one observation and with none, landmarks behind the
    cameras, NaN observations on observed and on unobserved slots, every
    fourth lane outside ``active``), launched once per B lanes, by
    ``_lm_cases.lm_hold``: in float64 base slots, valid and steps equal on
    every track and positions within 1e-8 m on every track valid in both;
    in float32 base slots exact, valid on 99.9 % of the tracks, and steps,
    converged positions beyond 1e-4 m and the widest converged gap no
    further apart than twice the plain version's own spread under one
    machine epsilon of its observations, plus a slack; M = 40 takes two
    slots a lane."""
    pool = lm_pool(B, 32, M, seed=B * M, dtype=dtype, device=cuda_device)
    before = _cuda.launch_counts["lm_triangulate"]
    got, steps, calls = lm_kernel_calls(pool, B)
    assert _cuda.launch_counts["lm_triangulate"] == before + calls
    assert got.pos_w.dtype == dtype and got.valid.dtype == torch.bool and got.base_slot.dtype == torch.int64
    k, n, missed = lm_hold(pool, got, steps)
    assert not missed, (missed, k, n)
    inactive = ~pool[-1]
    assert bool((steps[inactive] == 0).all()) and bool((steps[~inactive] >= 1).all())
    assert bool(got.valid.any()) and not bool(got.valid.all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_triangulate_kernel_stops_on_a_non_finite_unobserved_slot(cuda_device, dtype):
    """A NaN or infinite observation on a slot without an observation makes
    the first step NaN in the plain version (its einsum weighs the slot by
    0), which ends the track at its two-view guess: so it does in the
    kernel, with the same valid and base slot and the position within
    ``LM_POS_TOL``.  The other tracks keep their steps."""
    from msckf_stereo_c_torch.models import triangulation as tri

    args = lm_problem(4, 8, 20, seed=5, dtype=dtype, device=cuda_device, hard=False)
    valid = args[1]
    clean_steps, want_steps = (torch.empty(valid.shape[:2], dtype=torch.int32, device=cuda_device) for _ in "ab")
    tri.triangulate_tracks_reference(*args, iters=clean_steps)
    obs, bad = args[0].clone(), torch.zeros_like(clean_steps, dtype=torch.bool)
    for b in range(4):
        ks = [k for k in range(8) if int(clean_steps[b, k]) > 1 and not bool(valid[b, k].all())][:3]
        for j, k in enumerate(ks):
            obs[b, k, int(torch.nonzero(~valid[b, k])[0]), j % 4] = (float("nan"), float("inf"), -float("inf"))[j]
            bad[b, k] = True
    assert int(bad.sum()) >= 8
    args = (obs,) + args[1:]
    want = tri.triangulate_tracks_reference(*args, iters=want_steps)
    got, steps, _ = lm_kernel_calls(args, 4)
    assert bool((want_steps[bad] == 1).all()) and torch.equal(want_steps[~bad], clean_steps[~bad])
    assert bool((steps[bad] == 1).all())
    assert torch.equal(got.valid[bad], want.valid[bad]) and torch.equal(got.base_slot, want.base_slot)
    tol = LM_POS_TOL[str(dtype).split(".")[-1]]
    assert float((got.pos_w - want.pos_w)[bad].abs().max()) <= tol


@pytest.mark.cuda
def test_lm_triangulate_kernel_falls_back_to_depth_one(cuda_device):
    """A track whose last cam1 view sits at the epipole of its base camera
    has a two-view depth of 0 to rounding (float64), so its initial guess
    falls back to depth 1 (|depth| <= 1e-8) in the plain version, and the
    kernel takes the same branch: steps, valid and base slots equal, and
    positions within ``LM_F64_WIDEST_M``."""
    from msckf_stereo_c_torch.models import triangulation as tri

    args = lm_problem(4, 8, 20, seed=6, dtype=torch.float64, device=cuda_device, hard=False)
    obs, valid, q, p, R01, t01, _ = args
    _, t, _, _, i0 = tri._stereo_pose_stack(q, p, valid, R01, t01)
    i_last = 19 - tri._first_true(torch.flip(valid, dims=[-1]))
    t_last = torch.take_along_dim(t, (2 * i_last + 1)[..., None, None], dim=2)[:, :, 0]  # the base origin in cam1
    obs = obs.clone()
    lane, track = torch.meshgrid(torch.arange(4, device=cuda_device), torch.arange(8, device=cuda_device),
                                 indexing="ij")
    obs[lane, track, i_last, 2:4] = t_last[..., :2] / t_last[..., 2:]
    b = obs[lane, track, i_last, 2:4] * t_last[..., 2:] - t_last[..., :2]
    assert float(b.abs().max()) < 1e-14  # the two-view depth is A.b / |A|^2
    args = (obs,) + args[1:]
    want_steps = torch.empty(valid.shape[:2], dtype=torch.int32, device=cuda_device)
    want = tri.triangulate_tracks_reference(*args, iters=want_steps)
    got, steps, _ = lm_kernel_calls(args, 4)
    assert torch.equal(steps, want_steps) and torch.equal(got.valid, want.valid)
    assert torch.equal(got.base_slot, want.base_slot)
    gap = (got.pos_w - want.pos_w).norm(dim=-1)[got.valid & want.valid]
    assert gap.numel() and float(gap.max()) <= LM_F64_WIDEST_M


@pytest.mark.cuda
def test_lm_triangulate_kernel_counts_and_no_sync(cuda_device):
    """Each call is one launch with no host read (torch's sync debug mode
    raises on one), and the per-track steps kept under a profiler leave
    the results bit for bit as a launch that counts nothing."""
    from torch.profiler import ProfilerActivity, profile

    from msckf_stereo_c_torch.models import triangulation as tri

    args = lm_problem(64, 32, 20, seed=3, device=cuda_device)
    plain = tri.triangulate_tracks(*args)
    before = _cuda.launch_counts["lm_triangulate"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            tri.triangulate_tracks(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _cuda.launch_counts["lm_triangulate"] == before + 3
    with profile(activities=[ProfilerActivity.CPU]):
        got = tri.triangulate_tracks(*args)
    steps = tri.lm_work_log[-1]
    assert steps.device == args[0].device and steps.dtype == torch.int32 and steps.shape == (64, 32)
    for a, b in zip(plain, got):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.cuda
def test_lm_triangulate_kernel_rejects_bad_input(cuda_device):
    from msckf_stereo_c_torch.models import triangulation as tri

    args = lm_problem(2, 4, 6, seed=1, device=cuda_device)
    with pytest.raises(TypeError):
        tri.triangulate_tracks(args[0].half(), *args[1:])
    with pytest.raises(TypeError):
        tri.triangulate_tracks(args[0], args[1].int(), *args[2:])
    with pytest.raises(TypeError, match="extrinsics"):
        tri.triangulate_tracks(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError, match="shape"):
        tri.triangulate_tracks(*args[:2], args[2][:, :5], *args[3:])
    big = lm_problem(1, 2, 65, seed=1, device=cuda_device, hard=False)
    with pytest.raises(ValueError, match="slots"):
        tri.triangulate_tracks(*big)
    empty = tri.triangulate_tracks(args[0][:, :0], args[1][:, :0], *args[2:])
    assert empty.pos_w.shape == (2, 0, 3) and empty.valid.shape == (2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("model", ["radtan", "equidistant"])
@pytest.mark.parametrize("shape", [(0, 2), (96, 2), (512, 144, 2), "strided"])
def test_undistort_points_kernel_matches_plain(cuda_device, shape, model, rotate, dtype):
    """Bit-equal to the plain chain for radtan without R, within
    chip_smoke.UNDISTORT_ULPS otherwise, for EuRoC cam0 and cam1 over the
    whole image; one launch a non-empty call, none for an empty one, and
    no host read (torch's sync debug mode raises on one)."""
    from msckf_stereo_c_torch.ops import camera as tcam

    for cam in (0, 1):
        full = (5, 192, 2) if shape == "strided" else shape
        pts, K, D, R = chip_smoke.undistort_case(full, cam, model, rotate, dtype, cuda_device, seed=cam)
        if shape == "strided":
            pts = pts[:, ::2]
        before = _cuda.launch_counts["undistort_points"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tcam.undistort_points(pts, K, D, model, R)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _cuda.launch_counts["undistort_points"] == before + int(pts.numel() > 0)
        want = tcam.undistort_points_reference(pts, K, D, model, R)
        assert got.shape == want.shape and got.dtype == dtype
        assert bool(torch.isfinite(want).all())
        if model == "radtan" and not rotate:
            assert torch.equal(got, want)
        else:
            assert chip_smoke.ulp_gap(got, want) <= chip_smoke.UNDISTORT_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_undistort_points_kernel_reprojects(cuda_device, model):
    """``new_intrinsics`` (cam1's) after R, against the plain chain."""
    from msckf_stereo_c_torch.ops import camera as tcam

    pts, K, D, R = chip_smoke.undistort_case((256, 2), 0, model, True, device=cuda_device, seed=4)
    K1 = chip_smoke.undistort_case((1, 2), 1, device=cuda_device)[1]
    got = tcam.undistort_points(pts, K, D, model, R, K1)
    want = tcam.undistort_points_reference(pts, K, D, model, R, K1)
    assert chip_smoke.ulp_gap(got, want) <= chip_smoke.UNDISTORT_ULPS


@pytest.mark.cuda
def test_undistort_points_kernel_rejects_bad_input(cuda_device):
    from msckf_stereo_c_torch.ops import camera as tcam

    pts, K, D, R = chip_smoke.undistort_case((8, 2), rotate=True, device=cuda_device)
    with pytest.raises(TypeError):
        tcam.undistort_points(pts.half(), K.half(), D.half())
    with pytest.raises(TypeError):
        tcam.undistort_points(pts, K, D.double())
    with pytest.raises(ValueError, match="device"):
        tcam.undistort_points(pts, K.cpu(), D)
    with pytest.raises(ValueError):
        tcam.undistort_points(pts[:, :1], K, D)
    with pytest.raises(ValueError):
        tcam.undistort_points(pts, K, D, R=R[:2])


PYRAMID_PASSES = {0: "float32", 1: "bfloat16", 3: "bfloat16_3x"}


def _pyramid_images(B, shape, dtype=torch.float32, device=None, seed=0):
    """B images (B, H, W) of grey levels 0-255 off the bf16 grid (noise on
    a blocky field), as the renderer's frames are."""
    rng = np.random.default_rng(seed)
    H, W = shape
    field = np.kron(rng.uniform(0, 255, (B, H // 4 + 1, W // 4 + 1)), np.ones((1, 4, 4)))[:, :H, :W]
    img = np.clip(field + rng.normal(0, 3, (B, H, W)), 0, 255)
    return torch.as_tensor(img, dtype=dtype, device=device)


def _hold_pyramid(imgs, cfg, passes):
    """``pyramids_for`` on the card against the plain chain at ``passes``:
    every level bit-equal, ``max(levels - 1, presmooth)`` launches, and no
    host read (torch's sync debug mode raises on one)."""
    from msckf_stereo_c_torch.models.frontend import pyramids_for

    before = _cuda.launch_counts["pyramid_level"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with matmul_precision_scope(PYRAMID_PASSES[passes]):
            got = pyramids_for(imgs, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _cuda.launch_counts["pyramid_level"] == before + max(cfg.pyramid_levels - 1, int(cfg.presmooth))
    want = chip_smoke.plain_pyramid(imgs, cfg, passes)
    assert len(got) == len(want) == cfg.pyramid_levels
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 64])
@pytest.mark.parametrize("shape", [(480, 752), (479, 751), (61, 95)])
@pytest.mark.parametrize("passes", [0, 1, 3])
@pytest.mark.parametrize("presmooth", [True, False])
def test_pyramid_level_kernel_matches_plain(cuda_device, presmooth, passes, shape, B):
    """The tracker pyramid of ``pyramid_level`` launches bit-equal to the
    plain chain on the card, presmoothed (3 launches for 4 levels: level 0
    and 1 from one) and raw, at every bf16 pass count, on even and odd
    sizes down to a level 3 of 8 x 12."""
    from msckf_stereo_c_torch.config import FrontendConfig

    _hold_pyramid(_pyramid_images(B, shape, device=cuda_device, seed=B), FrontendConfig(presmooth=presmooth), passes)


@pytest.mark.cuda
@pytest.mark.parametrize("presmooth", [True, False])
def test_pyramid_level_kernel_float64_and_other_depths(cuda_device, presmooth):
    """Float64 images (the passes leave them as they are) and pyramids of
    1, 2 and 5 levels, bit-equal to the plain chain."""
    from msckf_stereo_c_torch.config import FrontendConfig

    imgs = _pyramid_images(3, (121, 187), torch.float64, cuda_device, seed=9)
    for passes in (0, 3):
        _hold_pyramid(imgs, FrontendConfig(presmooth=presmooth), passes)
    for levels in (1, 2, 5):
        _hold_pyramid(imgs.float(), FrontendConfig(presmooth=presmooth, pyramid_levels=levels), 0)


@pytest.mark.cuda
def test_pyramid_level_kernel_shapes_and_stacks(cuda_device):
    """One (H, W) image, a stack past the grid's 65,535 images, an empty
    stack (no launch) and the three entry points alone, each one launch,
    against the plain chain."""
    from msckf_stereo_c_torch.ops import pyramid as tpyr

    one = _pyramid_images(1, (480, 752), device=cuda_device, seed=3)[0]
    many = _pyramid_images(65_600, (5, 7), device=cuda_device, seed=4)
    for img in (one, many):
        for full, half in ((True, True), (True, False), (False, True)):
            before = _cuda.launch_counts["pyramid_level"]
            got = tpyr.pyramid_level(img, full, half)
            assert _cuda.launch_counts["pyramid_level"] == before + 1
            want = tpyr.pyramid_level_reference(img, full, half)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
        assert torch.equal(tpyr.pyr_down(img), tpyr.pyramid_level_reference(img, False, True)[1])
        assert torch.equal(tpyr.smooth5(img), tpyr.pyramid_level_reference(img, True, False)[0])
    before = _cuda.launch_counts["pyramid_level"]
    full, half = tpyr.pyramid_level(torch.zeros((0, 60, 94), device=cuda_device))
    assert full.shape == (0, 60, 94) and half.shape == (0, 30, 47)
    assert _cuda.launch_counts["pyramid_level"] == before


@pytest.mark.cuda
def test_pyramid_level_kernel_rejects_bad_input(cuda_device):
    from msckf_stereo_c_torch.ops import pyramid as tpyr

    with pytest.raises(TypeError):
        tpyr.pyr_down(torch.zeros((60, 94), dtype=torch.float16, device=cuda_device))
    with pytest.raises(TypeError):
        tpyr.smooth5(torch.zeros((60, 94), dtype=torch.uint8, device=cuda_device))
    with pytest.raises(ValueError):
        tpyr.pyr_down(torch.zeros((4, 2, 94), device=cuda_device))
    with pytest.raises(ValueError):
        tpyr.pyr_down(torch.zeros((94,), device=cuda_device))
    with pytest.raises(ValueError):
        tpyr.pyramid_level(torch.zeros((60, 94), device=cuda_device), full=False, half=False)
