"""The port's three hand-written CUDA kernels, their wrappers and their
plain versions.

The tests marked ``cuda`` hold each kernel against its plain version on the
card and skip without one; the rest run anywhere.  This file imports neither
JAX nor the JAX package, so on the machine with the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(the JAX parity of the plain versions is in test_torch_patch_extract.py and
test_torch_klt_corr.py)."""
import numpy as np
import pytest
import torch

from chip_smoke import lk_trace
from msckf_stereo_c_torch.ops import _cuda
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
    tq = kc._template_quantities(kc._interp_template(a, pts, P), P)
    sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
    Cx, Cy = kc._corr_surfaces(kc._extract_at_origins(b, sorg, S), tq.gx, tq.gy, P)
    f0 = pts - (P - 1) / 2.0 - sorg
    frozen = ~tq.good
    frozen[::9] = True
    sc = torch.stack([tq.G[:, 0, 0], tq.G[:, 0, 1], tq.G[:, 1, 1], tq.tgx, tq.tgy,
                      f0[:, 0], f0[:, 1], frozen.float()], -1)
    return sc, Cx, Cy, ~frozen


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
    tq = kc._template_quantities(kc._interp_template(a, pts, P), P, norm)
    sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
    Cx, Cy, Ct = kc._surfaces_for_norm(kc._extract_at_origins(b, sorg, S), tq, P, norm)
    f0 = pts - (P - 1) / 2.0 - sorg
    frozen = ~tq.good
    frozen[::9] = True
    B = tq.Binv
    sc = torch.stack([B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1], B[:, 1, 2],
                      tq.tgx, tq.tgy, tq.st2, f0[:, 0], f0[:, 1], frozen.float()], -1)
    return sc, Cx, Cy, Ct, ~frozen


def test_four_taps_give_the_plain_loop():
    """The tent weights are non-zero only on the 2x2 cells around f, and a
    frozen lane never moves: the kernel's per-lane four-tap loop gives the
    plain version's full K*K sum with a batch-wide exit, within 2 * eps
    (a lane may freeze one sub-eps step apart)."""
    sc, Cx, Cy, live = _lk_problem(0, 64)
    want = kc.lk_corr_iterate(sc, Cx, Cy, ITERS, EPS, HI).numpy()
    got, _, _ = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy()), ITERS, EPS, HI)
    assert live.sum() > 40
    np.testing.assert_allclose(got[live.numpy()], want[live.numpy()], rtol=0, atol=2 * EPS)
    np.testing.assert_array_equal(want[~live.numpy()], sc[~live, 5:7].numpy())


def test_k1_trace_counts_the_sectors_the_steps_read():
    """A lane frozen at the start takes no step and reads no surface; each
    step reads two rows of 2x2 cells, so one to two 32-byte sectors per row,
    and a lane that steps reads at least its two rows' sectors: far less
    than the whole surfaces."""
    sc, Cx, Cy, live = _lk_problem(2, 40)
    _, steps, sectors = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy()), ITERS, EPS, HI)
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
    got, steps, sectors = lk_trace(sc.numpy(), (Cx.numpy(), Cy.numpy(), Ct.numpy()), ITERS, EPS, HI)
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
