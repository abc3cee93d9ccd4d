"""The bf16 matmul precisions ('bfloat16': one bf16 pass a product,
'bfloat16_3x': three) in the port, against the JAX package's functions on
rounded operands.

JAX's CPU backend ignores the precision names (the exact f32 product comes
back) and jax 0.9 rejects 'bfloat16_3x', so the TPU meaning is built here
from the JAX package's own bilinear functions applied to the bf16 parts:
``r(x)`` is ``jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)``;
one pass is f(r(a), r(b)); three passes are f(hi, hi) + f(hi, lo) +
f(lo, hi) with hi = r(x), lo = r(x - hi).

Tolerances, each from the float32 rounding of sums taken in another order
(a product of two bf16 values is exact in float32):
- ``round_bf16``: bit for bit (NaN as NaN);
- correlation surfaces: 1e-5 x max|C| of each surface (the f32 kernels'
  bar);
- LK points: 5e-2 px on lanes that step (tests/test_torch_lk_align.py's:
  a lane whose step sits at eps = 0.01 px may freeze one step apart);
  frozen lanes exactly;
- resample: 1e-4 grey levels (tests/test_torch_lk_align_gain.py's);
- pyramids: 1e-4 grey levels (a few float32 ulps at 255) on all but 0.5 %
  of the pixels.  There the row pass's float32 value, summed in another
  order than JAX's dot, sits on a rounding boundary of the column pass's
  operand and the two round apart by one unit of its last bf16 part: at
  most 1 grey level under one pass (one bf16 unit at 255), 4e-3 under
  three (one unit of lo, 2^-8 of a bf16 unit; 3 of 5734 pixels in the
  measured run, 1.8e-4 off);
- product helper: 1e-6 x max|exact| (f32 sums of up to 60 terms);
- the whole slice (both configs at 'bfloat16_3x' against JAX's float32 run
  on the CPU, 12 bench frames, filter in float32): feature ids equal on the
  first 8 frames, positions within 1e-4 m (measured 8.2e-6 m on a run of
  the same configurations over the first 16 frames)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import msckf_stereo_c_tpu.config as jconfig
import msckf_stereo_c_tpu.ops.klt_corr as jkc
import msckf_stereo_c_tpu.ops.pyramid as jpyr
from msckf_stereo_c_torch import config as tconfig
from msckf_stereo_c_torch.io.tum import evaluate_ate
from msckf_stereo_c_torch.models.vio import run_vio_sequence
from msckf_stereo_c_torch.ops import klt_corr as kc
from msckf_stereo_c_torch.ops import precision
from msckf_stereo_c_torch.ops import pyramid as tpyr
from msckf_stereo_c_torch.ops.patch_extract import extract_windows
from msckf_stereo_c_tpu.models.vio import run_vio_sequence as jax_run_vio_sequence
from msckf_stereo_c_tpu.sim import make_circle_trajectory, make_wall_landmarks, synthesize_imu
from msckf_stereo_c_tpu.sim.render import render_stereo_sequence
from test_torch_lk_align import _texture
from test_torch_lk_align import _problem as _align_problem
from test_torch_lk_align_gain import _problem as _gain_problem
from test_torch_lk_align_gain import _resample_problem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, ITERS, EPS = 15, 30, 0.01
PT_TOL = 5e-2
SURF_RTOL = 1e-5
PASSES = [1, 3]


def jround(x):
    """r(x) by the JAX package's own cast."""
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16).astype(jnp.float32))


def jsplit(x):
    x = np.asarray(x, np.float32)
    hi = jround(x)
    return hi, jround(x - hi)


def jax_passes(fn, a, bs, passes):
    """The TPU meaning of the multilinear-in-(a, b) ``fn(a, *bs)`` under
    ``passes``, from the JAX function on bf16 parts, summed in float64."""
    if passes == 1:
        return np.asarray(fn(jround(a), *(jround(b) for b in bs)), np.float64)
    (ah, al), parts = jsplit(a), [jsplit(b) for b in bs]
    out = np.asarray(fn(ah, *(h for h, _ in parts)), np.float64)
    out = out + np.asarray(fn(ah, *(lo for _, lo in parts)), np.float64)
    return out + np.asarray(fn(al, *(h for h, _ in parts)), np.float64)


def test_round_bf16_matches_jax():
    """Random values over the whole exponent range, exact ties (even and
    odd), subnormals, the largest floats (which round to inf), +-0, +-inf
    and NaN."""
    rng = np.random.default_rng(0)
    bits = [rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)]
    heads = rng.integers(0, 2**16, 500, dtype=np.uint64).astype(np.uint32) << 16
    bits.append(heads | 0x8000)  # ties to even
    bits.append(heads | 0x7FFF)
    bits.append(heads | 0x8001)
    bits.append(rng.integers(1, 2**23, 500, dtype=np.uint64).astype(np.uint32))  # subnormals
    bits.append(np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0x7F7FFFFF, 0xFF7FFFFF,
                          0x7F7F8000, 0x00008000, 0x00018000], np.uint32))
    x = np.concatenate(bits).view(np.float32)
    got = precision.round_bf16(torch.as_tensor(x)).numpy()
    want = jround(x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    hi, lo = precision.split_bf16(torch.as_tensor(x[~nan & np.isfinite(x)]))
    jhi, jlo = jsplit(x[~nan & np.isfinite(x)])
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), jhi.view(np.uint32))
    np.testing.assert_array_equal(np.isnan(lo.numpy()), np.isnan(jlo))


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("nf", [2, 3])
def test_corr_surfaces_match_jax(nf, passes):
    """``_corr_surfaces`` with two and three filters against the JAX
    package's ``_corr_surfaces`` on the bf16 parts."""
    rng = np.random.default_rng(10 + nf)
    N, S = 24, 35
    spatch = _texture(nf, 120, 188)[:S, :S][None] + rng.uniform(0, 30, (N, S, S)).astype(np.float32)
    filters = [rng.normal(0, 20, (N, P, P)).astype(np.float32) for _ in range(nf)]
    got = kc._corr_surfaces(torch.as_tensor(spatch), *(torch.as_tensor(f) for f in filters[:2]), P,
                            extra=tuple(torch.as_tensor(f) for f in filters[2:]), passes=passes)
    want = jax_passes(lambda sp, *fs: np.stack(jkc._corr_surfaces(sp, fs[0], fs[1], P, extra=fs[2:])),
                      spatch, filters, passes)
    for i in range(nf):
        cmax = np.abs(want[i]).max()
        assert np.abs(got[i].numpy() - want[i]).max() <= SURF_RTOL * cmax
    # The passes move the surfaces: they are not the float32 ones.
    f32 = kc._corr_surfaces(torch.as_tensor(spatch), *(torch.as_tensor(f) for f in filters[:2]), P,
                            extra=tuple(torch.as_tensor(f) for f in filters[2:]))
    assert not torch.equal(f32[0], got[0])


def _jax_loop(d, filters, spatch_np, passes, norm):
    """JAX's surfaces of the rounded operands fed through its LK loop (the
    Pallas kernel in interpret mode)."""
    jq = jkc._template_quantities(jnp.asarray(d["sp"].numpy()), P, norm)
    surf = jax_passes(lambda sp, *fs: np.stack(jkc._corr_surfaces(sp, fs[0], fs[1], P, extra=fs[2:])),
                      spatch_np, [f.numpy() for f in filters], passes).astype(np.float32)
    Ct = jnp.asarray(surf[2]) if len(filters) == 3 else None
    sc = d["sc"].numpy()
    f0 = sc[:, 9:11] if len(filters) == 3 else sc[:, 5:7]
    frozen = d["frozen"].numpy()
    return np.asarray(jkc._run_iterations(jnp.asarray(surf[0]), jnp.asarray(surf[1]), Ct, jq, jnp.asarray(f0),
                                          jnp.asarray(frozen), ITERS, EPS, d["S"], P, "interpret")), f0, frozen


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("norm", ["none", "zeromean"])
def test_align_reference_matches_jax(norm, passes):
    """``lk_corr_align_reference`` at each pass count (and the wrapper on
    the CPU, at the scope's count) against JAX's surfaces of the rounded
    operands through JAX's loop; the loop is float32 in every mode."""
    d = _align_problem(4, 40, 120, 188, norm)
    S = d["S"]
    img1 = torch.as_tensor(d["img1"])
    spatch = extract_windows(img1, d["org"], S).numpy()
    want, f0, frozen = _jax_loop(d, (d["gx"], d["gy"]), spatch, passes, norm)
    args = (img1, d["org"], S, d["gx"], d["gy"], d["sc"], ITERS, EPS, float(S - P - 1))
    got = kc.lk_corr_align_reference(*args, passes=passes).numpy()
    assert np.abs(got - want)[~frozen].max() <= PT_TOL
    np.testing.assert_array_equal(got[frozen], f0[frozen])
    with tconfig.matmul_precision_scope("bfloat16" if passes == 1 else "bfloat16_3x"):
        np.testing.assert_array_equal(kc.lk_corr_align(*args).numpy(), got)


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("norm", ["gain", "offset"])
def test_align_gain_reference_matches_jax(norm, passes):
    """``lk_corr_align_gain_reference`` at each pass count against JAX's
    three surfaces of the rounded operands through its affine-photometric
    loop (interpret mode)."""
    d = _gain_problem(4, 40, 120, 188, norm)
    S = d["S"]
    img1 = torch.as_tensor(d["img1"])
    spatch = extract_windows(img1, d["org"], S).numpy()
    want, f0, frozen = _jax_loop(d, d["filters"], spatch, passes, norm)
    args = (img1, d["org"], S, *d["filters"], d["sc"], ITERS, EPS, float(S - P - 1))
    got = kc.lk_corr_align_gain_reference(*args, passes=passes).numpy()
    assert (~frozen).sum() > 20
    assert np.abs(got - want)[~frozen].max() <= PT_TOL
    np.testing.assert_array_equal(got[frozen], f0[frozen])
    np.testing.assert_array_equal(kc.lk_corr_align_gain(*args, passes=passes).numpy(), got)


_JAX_SAMPLE = """
import sys
import numpy as np
import jax.numpy as jnp
import msckf_stereo_c_tpu.ops.klt_corr as jkc
import msckf_stereo_c_tpu.ops.klt_gemm as jkg
d = np.load(sys.argv[1])
P, Sb = int(d["P"]), int(d["Sb"])
q = P + 2
ob = np.clip(d["pts"] - (P + 1) / 2.0 - d["o1"], 0.0, Sb - (P + 3.0)).astype(np.float32)
block = jkc._extract_at_origins(jnp.asarray(d["img"]), jnp.asarray(d["o1"]), Sb, "interpret")
out = jkc._sample(jkc._tent_weights(jnp.asarray(ob[:, 1]), q, Sb, jnp.float32), block,
                  jkc._tent_weights(jnp.asarray(ob[:, 0]), q, Sb, jnp.float32))
assert jkg._COMPUTE_DTYPE == jnp.bfloat16
np.save(sys.argv[2], np.asarray(out))
"""


def test_resample_reference_matches_jax_bf16_sample(tmp_path):
    """One pass: ``resample_template_reference`` against JAX's ``_sample``
    with its bf16 compute dtype (``MSCKF_KLT_BF16=1``, read when the module
    is imported, so in a JAX process of its own): the weights and pixels
    rounded, the products and the intermediate in float32."""
    img, pts, o1, Sb = _resample_problem(5, 40, 120, 188)
    np.savez(tmp_path / "in.npz", img=img.numpy(), pts=pts.numpy(), o1=o1.numpy(), P=P, Sb=Sb)
    env = dict(os.environ, MSCKF_KLT_BF16="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run([sys.executable, "-c", _JAX_SAMPLE, str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(tmp_path / "out.npy")
    org = o1.to(torch.int32)
    got = kc.resample_template_reference(img, pts, org, Sb, P, passes=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    f32 = kc.resample_template_reference(img, pts, org, Sb, P).numpy()
    assert np.abs(f32 - want).max() > 1e-2  # the weights' rounding shows
    np.testing.assert_array_equal(kc.resample_template(img, pts, org, Sb, P, passes=1).numpy(), got)


def test_resample_reference_three_passes():
    """Three passes: weights and pixels as hi + lo (16 bits), against the
    tent-weight product of those operands in float64, and within 2^-15 of
    the float32 resample (the pixels here reach 255)."""
    img, pts, o1, Sb = _resample_problem(6, 40, 120, 188)
    org = o1.to(torch.int32)
    q = P + 2
    ob = torch.clamp(pts - (P + 1) / 2.0 - o1, 0.0, Sb - (P + 3.0))
    Wy, Wx = kc._tent_weights(ob[:, 1], q, Sb), kc._tent_weights(ob[:, 0], q, Sb)
    block = extract_windows(img, org, Sb)
    hl = [np.asarray(sum(jsplit(x.numpy())), np.float64) for x in (Wy, block, Wx)]
    want = np.einsum("nij,njk,nlk->nil", *hl)
    got = kc.resample_template_reference(img, pts, org, Sb, P, passes=3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    f32 = kc.resample_template_reference(img, pts, org, Sb, P).numpy()
    assert 0 < np.abs(got - f32).max() <= 255 * 2.0**-15


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("fn", ["pyr_down", "smooth5"])
def test_pyramid_matches_jax_matrices(fn, passes):
    """``pyr_down`` and ``smooth5`` under the scope's passes against the
    JAX package's banded matrices (``_decim_matrix``, ``_smooth_matrix``)
    applied as its two dots: each dot's image operand rounded (rows first,
    then columns); the weights are exact in bf16."""
    H, W = 61, 94
    img = _texture(7, H, W) + np.float32(0.37)  # not representable in bf16
    mat = jpyr._decim_matrix if fn == "pyr_down" else jpyr._smooth_matrix
    Dh, Dw = mat(H).astype(np.float64), mat(W).astype(np.float64)

    def operand(x):
        return np.asarray(jround(x) if passes == 1 else sum(jsplit(x)), np.float64)

    rows = Dh @ operand(img)
    want = operand(rows.astype(np.float32)) @ Dw.T
    with tconfig.matmul_precision_scope("bfloat16" if passes == 1 else "bfloat16_3x"):
        got = getattr(tpyr, fn)(torch.as_tensor(img)).numpy()
    err = np.abs(got - want)
    assert (err > 1e-4).mean() <= 0.005
    assert err.max() <= (1.0 if passes == 1 else 4e-3)
    assert not np.array_equal(got, getattr(tpyr, fn)(torch.as_tensor(img)).numpy())


def _exact(fn, a, b, passes):
    """fn on the bf16 parts in float64: the passes' products, exactly."""
    if passes == 1:
        return fn(torch.as_tensor(jround(a)).double(), torch.as_tensor(jround(b)).double())
    (ah, al), (bh, bl) = jsplit(a), jsplit(b)
    d = [torch.as_tensor(x).double() for x in (ah, al, bh, bl)]
    return fn(d[0], d[2]) + fn(d[0], d[3]) + fn(d[1], d[2])


PRODUCTS = {
    "matmul": (lambda a, b: a @ b, (3, 7, 20), (20, 5)),
    "bmm": (torch.bmm, (4, 6, 30), (4, 30, 5)),
    "bmm_k1": (torch.bmm, (4, 6, 1), (4, 1, 5)),  # nothing to sum: elementwise, exact
    "einsum": (lambda a, b: torch.einsum("zkiac,zkjcb->zkijab", a, b), (2, 3, 4, 5, 6), (2, 3, 2, 6, 7)),
    "conv2d": (lambda a, b: F.conv2d(a, b, groups=3), (1, 3, 12, 12), (6, 1, 5, 5)),
}


@pytest.mark.parametrize("passes", PASSES)
@pytest.mark.parametrize("op", sorted(PRODUCTS))
def test_product_helper(op, passes):
    """``@``, ``bmm`` (with a summed extent of 1 too), ``einsum`` and a
    grouped ``conv2d`` inside the scope against the float64 products of the
    rounded parts; outside it, the float32 product."""
    fn, sa, sb = PRODUCTS[op]
    rng = np.random.default_rng(len(op) + passes)
    a, b = (rng.normal(0, 3, s).astype(np.float32) for s in (sa, sb))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    with precision.products(passes):
        got = fn(ta, tb)
    want = _exact(fn, a, b, passes)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert not torch.equal(fn(ta, tb), got)


def test_float64_and_integer_products_untouched():
    """Inside the scope, float64 and integer products are the plain ones,
    bit for bit, as on the TPU."""
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(5, 8, 9)), rng.normal(size=(5, 9, 4))
    i, j = rng.integers(-50, 50, (6, 7)), rng.integers(-50, 50, (7, 3))
    plain = [torch.as_tensor(a) @ torch.as_tensor(b), torch.einsum("zij,zjk->zik", torch.as_tensor(a),
             torch.as_tensor(b)), torch.as_tensor(i) @ torch.as_tensor(j)]
    with tconfig.matmul_precision_scope("bfloat16_3x"):
        scoped = [torch.as_tensor(a) @ torch.as_tensor(b), torch.einsum("zij,zjk->zik", torch.as_tensor(a),
                  torch.as_tensor(b)), torch.as_tensor(i) @ torch.as_tensor(j)]
    for p, s in zip(plain, scoped):
        assert p.dtype == s.dtype and torch.equal(p, s)


def test_scope_restores_flags_and_pass_count():
    """A bf16 name turns TF32 off and sets the pass count; leaving the scope
    (nested or not, and on an exception) brings both back, and products
    after it are float32 again."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    a = torch.randn(6, 6)
    f32 = a @ a
    with tconfig.matmul_precision_scope("default"):
        with tconfig.matmul_precision_scope("bfloat16_3x"):
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
            assert precision.active_passes() == 3
            with tconfig.matmul_precision_scope("float32"):
                assert precision.active_passes() == 0
                assert torch.equal(a @ a, f32)
            with tconfig.matmul_precision_scope("bfloat16"):
                assert precision.active_passes() == 1
            assert precision.active_passes() == 3
        assert torch.backends.cuda.matmul.allow_tf32 is True and precision.active_passes() == 0
    with pytest.raises(RuntimeError):
        with tconfig.matmul_precision_scope("bfloat16"):
            raise RuntimeError("inside")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == prev
    assert precision.active_passes() == 0 and torch.equal(a @ a, f32)
    with pytest.raises(ValueError, match="passes"):
        kc.resample_template(torch.zeros(40, 40), torch.zeros(1, 2), torch.zeros(1, 2, dtype=torch.int32), 37, P,
                             passes=2)


FKW = dict(max_features=48)
MKW = dict(max_cam_state_size=6, max_tracks=64, max_imu_per_frame=10, ns_iters=10)
SLICE_IDX = np.arange(290, 410, 10)  # 12 frames of the moving part of the circle


@pytest.fixture(scope="module")
def slice_scene():
    """The bench circle (tests/test_torch_vio.py's) over 12 frames, and the
    JAX package's run at 'float32' in both configs on the CPU (filter in
    float32, the Pallas LK loop in interpret mode: the port's template
    formula)."""
    traj = make_circle_trajectory(duration=3.0)
    lms = make_wall_landmarks(num=300, radius=8.0, seed=1)
    imu = synthesize_imu(traj, gyro_noise=1e-4, acc_noise=1e-3, seed=0)
    img0, img1 = render_stereo_sequence(traj, lms, SLICE_IDX, r_wall=8.0)
    mode = jkc._LOOP_MODE
    jkc._LOOP_MODE = "interpret"
    try:
        jres = jax_run_vio_sequence(
            jconfig.FrontendConfig(**FKW, matmul_precision="float32"),
            jconfig.FilterConfig(**MKW, matmul_precision="float32"), jconfig.EUROC_CALIB, traj.t[SLICE_IDX],
            img0, img1, traj.t, imu.gyro, imu.acc, filter_dtype=jnp.float32, method="schur", chunk=len(SLICE_IDX),
        )
    finally:
        jkc._LOOP_MODE = mode
    return traj, imu, img0, img1, jres


def _port_run(scene, front, filt):
    traj, imu, img0, img1, _ = scene
    return run_vio_sequence(
        tconfig.FrontendConfig(**FKW, matmul_precision=front), tconfig.FilterConfig(**MKW, matmul_precision=filt),
        tconfig.EUROC_CALIB, traj.t[SLICE_IDX], img0, img1, traj.t, imu.gyro, imu.acc,
        filter_dtype=torch.float32, method="schur", chunk=len(SLICE_IDX), device="cpu",
    )


def test_vio_sequence_three_passes_against_jax_float32(slice_scene):
    """The whole slice: ``run_vio_sequence`` with the front end and the
    filter at 'bfloat16_3x' against JAX's float32 run: ids equal on the
    first 8 frames, positions within 1e-4 m."""
    jres = slice_scene[-1]
    res = _port_run(slice_scene, "bfloat16_3x", "bfloat16_3x")
    np.testing.assert_array_equal(res.fid[:8], np.asarray(jres.fid)[:8])
    np.testing.assert_array_equal(res.valid[:8], np.asarray(jres.valid)[:8])
    assert np.isfinite(res.positions).all()
    np.testing.assert_allclose(res.positions, np.asarray(jres.positions), rtol=0, atol=1e-4)
    assert res.tracking["after_ransac"].min() > 10


def test_one_pass_front_end_runs(slice_scene, capsys):
    """'bfloat16' in the front end (one pass: pyramids, surfaces, resample,
    the tracker's products) runs and keeps tracking; its ATE is printed
    beside the float32 run's."""
    traj = slice_scene[0]
    res = _port_run(slice_scene, "bfloat16", "float32")
    ref = _port_run(slice_scene, "float32", "float32")
    gt = traj.p[SLICE_IDX]
    ate = evaluate_ate(res.times, res.positions, traj.t[SLICE_IDX], gt).rmse
    ate_ref = evaluate_ate(ref.times, ref.positions, traj.t[SLICE_IDX], gt).rmse
    with capsys.disabled():
        print(f"\n[precision] 12 frames: ATE {ate:.6f} m front end 'bfloat16', {ate_ref:.6f} m 'float32'")
    assert np.isfinite(ate) and res.tracking["after_ransac"].min() > 10
    assert not np.array_equal(res.positions, ref.positions)
