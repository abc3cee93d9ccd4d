"""Lucas-Kanade via precomputed correlation surfaces, with the photometric
norms 'none', 'zeromean', 'offset' and 'gain' (port of
``msckf_stereo_c_tpu/ops/klt_corr.py``).

The LK right-hand side is linear in the sampled patch, so each alignment
problem precomputes two (K, K) cross-correlations of the template gradients
with its search window (K = S - P + 1) and every Gauss-Newton step only
interpolates them bilinearly (see the JAX module for the identity).

Three kernels carry it on the card: ``lk_corr_iterate`` (the iteration
loop, ``csrc/lk_corr_iterate.cu``; norms 'none' and 'zeromean'),
``lk_corr_iterate_gain`` (the affine-photometric loop with a third surface,
``csrc/lk_corr_iterate_gain.cu``; norms 'offset' and 'gain') and
``patch_extract.extract_windows`` (the template and search windows).  A CPU
tensor takes each kernel's plain version.  The correlation surfaces are a
depthwise ``conv2d`` and the backward template's resampling an ``einsum``,
as the JAX package left them to XLA.

Templates always come from the (P+3) window plus four static bilinear
slices (``_interp_template``), the formula the TPU ran; the template carried
from the stereo call into the next temporal call depends on one formula for
both.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import _cuda
from .patch_extract import extract_windows

# Search radius beyond the window per level (klt_gemm.py:_SEARCH_RADIUS).
_SEARCH_RADIUS = 9
# OpenCV minEigThreshold default, per-pixel scaled (klt.py).
_MIN_EIG_THRESHOLD = 1e-4


class KltResult(NamedTuple):
    pts: torch.Tensor  # (N, 2) refined positions [x, y]
    valid: torch.Tensor  # (N,) bool tracking success


def _clip_xy(x: torch.Tensor, lo: float, hi_x: float, hi_y: float) -> torch.Tensor:
    """jnp.clip(x, lo, [hi_x, hi_y]) for (N, 2) [x, y] coordinates."""
    x = torch.clamp(x, min=lo)
    return torch.stack([torch.clamp(x[:, 0], max=hi_x), torch.clamp(x[:, 1], max=hi_y)], dim=-1)


def _tent_weights(frac_origin: torch.Tensor, out_size: int, in_size: int) -> torch.Tensor:
    """(..., out_size, in_size) W[i, j] = tent(j - (frac_origin + i)): rows
    [frac_origin, frac_origin + out_size) of a length-in_size signal by
    linear interpolation."""
    dev, dt = frac_origin.device, frac_origin.dtype
    i = torch.arange(out_size, device=dev, dtype=dt)[:, None]
    j = torch.arange(in_size, device=dev, dtype=dt)[None, :]
    d = j - (frac_origin[..., None, None] + i)
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _sample(Wy: torch.Tensor, patch: torch.Tensor, Wx: torch.Tensor) -> torch.Tensor:
    """sampled = Wy @ patch @ Wx^T per feature."""
    return torch.einsum("nij,njk,nlk->nil", Wy, patch, Wx)


def _corr_surfaces(spatch: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, P: int, extra=()):
    """(N, K, K) cross-correlations of gx, gy and the ``extra`` per-feature
    filters with each search window, as one depthwise convolution (features
    = channels, F filters each).  Returns F strided views into one
    (N, F, K, K) result."""
    N, S, _ = spatch.shape
    filters = (gx, gy) + tuple(extra)
    nf = len(filters)
    weight = torch.stack(filters, dim=1).reshape(nf * N, 1, P, P)
    out = F.conv2d(spatch[None], weight, groups=N)  # (1, F*N, K, K)
    K = S - P + 1
    out = out.reshape(N, nf, K, K)
    return tuple(out[:, i] for i in range(nf))


class TemplateQ(NamedTuple):
    """Per-feature template quantities for one alignment problem.

    ``tgx``/``tgy`` are adjusted for the photometric norm: raw for 'none'
    and 'offset', zero-meaned for 'zeromean' and 'gain'.  Fields after
    ``tgy`` are None except where the norm needs them."""

    gx: torch.Tensor  # (N, P, P) template x-gradient
    gy: torch.Tensor  # (N, P, P)
    G: torch.Tensor  # (N, 2, 2) normal matrix
    good: torch.Tensor  # (N,) min-eig quality gate
    min_eig: torch.Tensor  # (N,) per-pixel min eigenvalue of G
    tgx: torch.Tensor  # (N,)
    tgy: torch.Tensor  # (N,)
    sgx: torch.Tensor | None = None  # (N,) sum of gx (every norm but 'none')
    sgy: torch.Tensor | None = None
    tmpl_c: torch.Tensor | None = None  # (N, P, P) zero-meaned template ('gain')
    st2: torch.Tensor | None = None  # (N,) sum (T - mean T)^2 ('gain'), sum T ('offset')
    Binv: torch.Tensor | None = None  # (N, 2, 3) displacement rows of the bordered inverse


def _bordered_inverse_rows(gxx, gxy, gyy, hx, hy, a22):
    """(N, 2, 3) displacement rows of inv([[gxx, gxy, hx], [gxy, gyy, hy],
    [hx, hy, a22]]) by cofactors: the photometric-augmented GN solve."""
    detA = gxx * (gyy * a22 - hy * hy) - gxy * (gxy * a22 - hy * hx) + hx * (gxy * hy - gyy * hx)
    inv_detA = 1.0 / torch.where(torch.abs(detA) > 1e-30, detA, torch.full_like(detA, 1e-30))
    B00 = (gyy * a22 - hy * hy) * inv_detA
    B01 = (hx * hy - gxy * a22) * inv_detA
    B02 = (gxy * hy - gyy * hx) * inv_detA
    B11 = (gxx * a22 - hx * hx) * inv_detA
    B12 = (gxy * hx - gxx * hy) * inv_detA
    return torch.stack([torch.stack([B00, B01, B02], -1), torch.stack([B01, B11, B12], -1)], -2)


def _template_quantities(sp: torch.Tensor, P: int, norm: str = "none") -> TemplateQ:
    """Gradients, normal matrix and quality of (N, P+2, P+2) super-patches,
    plus what the photometric ``norm`` needs (see the JAX original):

    'zeromean': template constants on the zero-meaned template, paired with
    mean-centred gradient filters: invariant to a brightness offset.
    'offset': a damped joint (translation, brightness-offset) solve whose
    border is the constant Jacobian (ones): raw tgx/tgy, the box sum in
    ``st2``, a 5 % damp on the offset block (n_px * 1.05).
    'gain': the affine-photometric solve, the gain unknown's Jacobian the
    zero-meaned template, with a 5 % relative damp on its block.
    'none' computes exactly what it always did."""
    templ = sp[:, 1:-1, 1:-1]
    gx = 0.5 * (sp[:, 1:-1, 2:] - sp[:, 1:-1, :-2])
    gy = 0.5 * (sp[:, 2:, 1:-1] - sp[:, :-2, 1:-1])
    gxx = torch.sum(gx * gx, (-2, -1))
    gxy = torch.sum(gx * gy, (-2, -1))
    gyy = torch.sum(gy * gy, (-2, -1))
    G = torch.stack([torch.stack([gxx, gxy], -1), torch.stack([gxy, gyy], -1)], -2)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    min_eig = (0.5 * tr - disc) / (P * P)
    good = min_eig > _MIN_EIG_THRESHOLD
    tgx = torch.sum(templ * gx, (-2, -1))
    tgy = torch.sum(templ * gy, (-2, -1))
    if norm == "none":
        return TemplateQ(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig, tgx=tgx, tgy=tgy)

    mt = torch.mean(templ, (-2, -1))
    sgx = torch.sum(gx, (-2, -1))
    sgy = torch.sum(gy, (-2, -1))
    base = dict(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig, sgx=sgx, sgy=sgy)
    if norm == "zeromean":
        return TemplateQ(tgx=tgx - mt * sgx, tgy=tgy - mt * sgy, **base)
    if norm == "offset":
        Binv = _bordered_inverse_rows(gxx, gxy, gyy, sgx, sgy, torch.full_like(sgx, P * P * 1.05))
        return TemplateQ(tgx=tgx, tgy=tgy, st2=torch.sum(templ, (-2, -1)), Binv=Binv, **base)
    if norm != "gain":
        raise ValueError(f"unknown klt norm {norm!r}")
    tgx_c = tgx - mt * sgx
    tgy_c = tgy - mt * sgy
    tmpl_c = templ - mt[:, None, None]
    st2 = torch.sum(tmpl_c * tmpl_c, (-2, -1))
    Binv = _bordered_inverse_rows(gxx, gxy, gyy, tgx_c, tgy_c, st2 * 1.05 + 1e-12)
    return TemplateQ(tgx=tgx_c, tgy=tgy_c, tmpl_c=tmpl_c, st2=st2, Binv=Binv, **base)


def _surfaces_for_norm(spatch: torch.Tensor, tq: TemplateQ, P: int, norm: str):
    """(Cx, Cy, Ct) for one alignment problem under ``norm``: Ct is the
    box-sum surface for 'offset', the zero-mean-template surface for 'gain'
    and None otherwise.  The zero-mean correction of 'zeromean' and 'gain'
    folds into mean-centred gradient filters by linearity."""
    if norm == "none":
        Cx, Cy = _corr_surfaces(spatch, tq.gx, tq.gy, P)
        return Cx, Cy, None
    if norm == "offset":
        return _corr_surfaces(spatch, tq.gx, tq.gy, P, extra=(torch.ones_like(tq.gx),))
    n = float(P * P)
    gxc = tq.gx - (tq.sgx / n)[:, None, None]
    gyc = tq.gy - (tq.sgy / n)[:, None, None]
    if norm == "zeromean":
        Cx, Cy = _corr_surfaces(spatch, gxc, gyc, P)
        return Cx, Cy, None
    return _corr_surfaces(spatch, gxc, gyc, P, extra=(tq.tmpl_c,))


def lk_corr_iterate_reference(
    sc: torch.Tensor, Cx: torch.Tensor, Cy: torch.Tensor, iters: int, eps: float, hi: float
) -> torch.Tensor:
    """Plain version of the iteration loop, as the JAX package's XLA loop
    (``_run_iterations``): the tent weights over all K*K cells every step and
    one exit for the whole batch once every lane has converged."""
    dtype = Cx.dtype
    K = Cx.shape[-1]
    gxx, gxy, gyy, tgx, tgy = (sc[:, i] for i in range(5))
    f = sc[:, 5:7]
    conv = sc[:, 7] > 0.5
    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    u = torch.arange(K, device=Cx.device, dtype=dtype)[None, :]
    for _ in range(iters):
        if bool(torch.all(conv)):
            break
        fx = torch.clamp(f[:, 0], 0.0, hi)
        fy = torch.clamp(f[:, 1], 0.0, hi)
        wx = torch.clamp(1.0 - torch.abs(u - fx[:, None]), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(u - fy[:, None]), min=0.0)
        w2 = wy[:, :, None] * wx[:, None, :]
        bx = tgx - torch.sum(w2 * Cx, (-2, -1))
        by = tgy - torch.sum(w2 * Cy, (-2, -1))
        delta = torch.stack(
            [(gyy * bx - gxy * by) * inv_det, (-gxy * bx + gxx * by) * inv_det], -1
        )
        new_f = torch.clamp(f + delta, 0.0, hi)
        now = torch.linalg.norm(delta, dim=-1) < eps
        f = torch.where(conv[:, None], f, new_f)
        conv = conv | now
    return f


def _launch_lk(name: str, reference, sc, surfaces, iters, eps, hi) -> torch.Tensor:
    """Shared wrapper of K1 and K3: checks sc (N, C) and the (N, K, K)
    surfaces, sends CPU tensors to ``reference`` and launches the kernel
    ``name`` on CUDA tensors (or raises)."""
    Cx = surfaces[0]
    N, K, _ = Cx.shape
    ncols = 4 * len(surfaces)  # 8 for K1, 12 for K3
    if sc.shape != (N, ncols) or any(c.shape != Cx.shape for c in surfaces):
        raise ValueError(f"{name}: sc (N, {ncols}) and {len(surfaces)} surfaces (N, K, K) expected")
    if not 0.0 <= hi <= K - 2:
        raise ValueError(f"hi={hi} must lie in [0, K-2] so all four taps stay in range")
    if sc.device.type == "cpu":
        return reference(sc, *surfaces, iters, eps, hi)
    if sc.device.type != "cuda":
        raise ValueError(f"unsupported device {sc.device}")
    if any(c.device != sc.device for c in surfaces):
        raise ValueError(f"{name} inputs must lie on one device")
    if any(x.dtype != torch.float32 for x in (sc, *surfaces)):
        raise TypeError(f"{name} takes float32 tensors")
    fstride = Cx.stride(0)
    if (
        not sc.is_contiguous()
        or Cx.stride()[1:] != (K, 1)
        or any(c.stride() != Cx.stride() for c in surfaces)
        or (N > 1 and fstride < K * K)
    ):
        raise ValueError(f"{name} needs row-major (K, K) surfaces with one feature stride")
    if 4 * len(surfaces) * K * K * 4 > 48 * 1024:
        raise ValueError(f"K={K}: the surfaces of four features exceed 48 KB of shared memory")
    out = torch.empty((N, 2), dtype=sc.dtype, device=sc.device)
    fn = _cuda.kernel_function(name)
    rc = fn(
        sc.data_ptr(), *(c.data_ptr() for c in surfaces), out.data_ptr(), fstride,
        N, K, int(iters), float(eps), float(hi),
        torch.cuda.current_stream(sc.device).cuda_stream,
    )
    _cuda.check_launch(name, rc)
    _cuda.launch_counts[name] += 1
    return out


def lk_corr_iterate(
    sc: torch.Tensor, Cx: torch.Tensor, Cy: torch.Tensor, iters: int, eps: float, hi: float
) -> torch.Tensor:
    """Up to ``iters`` LK steps per feature on precomputed surfaces (K1).

    sc (N, 8) = (gxx, gxy, gyy, tgx, tgy, f0x, f0y, converged0); Cx, Cy
    (N, K, K), possibly views sharing one feature stride.  Returns the
    final window-origin coordinates f (N, 2), each clamped to [0, hi]."""
    return _launch_lk("lk_corr_iterate", lk_corr_iterate_reference, sc, (Cx, Cy), iters, eps, hi)


def lk_corr_iterate_gain_reference(
    sc: torch.Tensor, Cx: torch.Tensor, Cy: torch.Tensor, Ct: torch.Tensor,
    iters: int, eps: float, hi: float,
) -> torch.Tensor:
    """Plain version of the affine-photometric loop, as the JAX package's
    XLA loop with a ``Ct`` (``_run_iterations``): the tent weights over all
    K*K cells every step, delta = Binv (bx, by, bt), and one exit for the
    whole batch once every lane has converged."""
    dtype = Cx.dtype
    N, K, _ = Cx.shape
    Binv = sc[:, 0:6].reshape(N, 2, 3)
    tgx, tgy, st2 = sc[:, 6], sc[:, 7], sc[:, 8]
    f = sc[:, 9:11]
    conv = sc[:, 11] > 0.5
    u = torch.arange(K, device=Cx.device, dtype=dtype)[None, :]
    for _ in range(iters):
        if bool(torch.all(conv)):
            break
        fx = torch.clamp(f[:, 0], 0.0, hi)
        fy = torch.clamp(f[:, 1], 0.0, hi)
        wx = torch.clamp(1.0 - torch.abs(u - fx[:, None]), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(u - fy[:, None]), min=0.0)
        w2 = wy[:, :, None] * wx[:, None, :]
        b3 = torch.stack(
            [tgx - torch.sum(w2 * Cx, (-2, -1)), tgy - torch.sum(w2 * Cy, (-2, -1)),
             st2 - torch.sum(w2 * Ct, (-2, -1))], -1,
        )
        delta = torch.einsum("nij,nj->ni", Binv, b3)
        new_f = torch.clamp(f + delta, 0.0, hi)
        now = torch.linalg.norm(delta, dim=-1) < eps
        f = torch.where(conv[:, None], f, new_f)
        conv = conv | now
    return f


def lk_corr_iterate_gain(
    sc: torch.Tensor, Cx: torch.Tensor, Cy: torch.Tensor, Ct: torch.Tensor,
    iters: int, eps: float, hi: float,
) -> torch.Tensor:
    """Up to ``iters`` affine-photometric LK steps per feature on
    precomputed surfaces (K3).

    sc (N, 12) = (B00, B01, B02, B10, B11, B12, tgx, tgy, st2, f0x, f0y,
    converged0); Cx, Cy, Ct (N, K, K), possibly views sharing one feature
    stride.  Returns the final window-origin coordinates f (N, 2), each
    clamped to [0, hi]."""
    return _launch_lk(
        "lk_corr_iterate_gain", lk_corr_iterate_gain_reference, sc, (Cx, Cy, Ct), iters, eps, hi
    )


def _run_iterations(Cx, Cy, tq: TemplateQ, f0, conv0, iters, eps, S, P, Ct=None):
    """Converged window-origin coordinates f (N, 2) for one alignment;
    a ``Ct`` selects the affine-photometric loop (K3) over K1."""
    hi = float(S - P - 1)
    if Ct is not None:
        B = tq.Binv
        sc = torch.stack(
            [B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1], B[:, 1, 2],
             tq.tgx, tq.tgy, tq.st2, f0[:, 0], f0[:, 1], conv0.to(Cx.dtype)],
            dim=-1,
        )
        return lk_corr_iterate_gain(sc, Cx, Cy, Ct, iters, eps, hi)
    sc = torch.stack(
        [tq.G[:, 0, 0], tq.G[:, 0, 1], tq.G[:, 1, 1], tq.tgx, tq.tgy,
         f0[:, 0], f0[:, 1], conv0.to(Cx.dtype)],
        dim=-1,
    )
    return lk_corr_iterate(sc, Cx, Cy, iters, eps, hi)


def _extract_at_origins(img, org, S):
    """(N, S, S) windows at integer-valued float origins (N, 2) [x, y]."""
    return extract_windows(img, org.to(torch.int32), S)


def _interp_template(img, pts, P):
    """(N, P+2, P+2) interpolated template super-patches at ``pts``: the
    (P+3) window at floor(pts - (P+1)/2) holds the fractional offset in
    [0, 1), so bilinear interpolation is four static slices."""
    H, W = img.shape
    q = P + 2
    Tq = P + 3
    torg = _clip_xy(torch.floor(pts) - (P + 1) // 2, 0.0, W - Tq, H - Tq)
    tpatch = _extract_at_origins(img, torg, Tq)
    a = torch.clamp(pts - (P + 1) / 2.0 - torg, 0.0, 1.0)
    ax = a[:, 0][:, None, None]
    ay = a[:, 1][:, None, None]
    return (
        tpatch[:, :q, :q] * (1 - ax) * (1 - ay)
        + tpatch[:, :q, 1 : q + 1] * ax * (1 - ay)
        + tpatch[:, 1 : q + 1, :q] * (1 - ax) * ay
        + tpatch[:, 1 : q + 1, 1 : q + 1] * ax * ay
    )


def fused_stereo_supported(img_shape, win: int) -> bool:
    """True when the image is large enough for ``stereo_anchor_lr_fused``'s
    margined search-window geometry."""
    return min(img_shape) >= win + 2 * _SEARCH_RADIUS + 4


def stereo_anchor_lr_fused(
    img0: torch.Tensor,
    img1: torch.Tensor,
    pts0: torch.Tensor,
    guess: torch.Tensor,
    valid_in: torch.Tensor,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
    anchor_sp: torch.Tensor | None = None,
    anchor_valid: torch.Tensor | None = None,
    anchor_radius: float = 2.0,
    norm: str = "none",
    anchor_norm: str | None = None,
):
    """Fused full-resolution stereo fine level: optional anchor-template
    refinement of the first A lanes of ``pts0``, forward LK img0 -> img1 and
    the backward left-right round trip, sharing window extractions (see the
    JAX original for the geometry).  ``norm`` is the photometric norm of the
    forward and backward problems, ``anchor_norm`` (default ``norm``) the
    anchor's.  Returns (pts0_out, anchor_accept (A,)
    or None, KltResult forward, rt2 (N,) round-trip squared error, +inf
    where the backward track is invalid, forward templates (N, P+2, P+2),
    forward-template min_eig (N,))."""
    H, W = img0.shape
    P = win
    S = min(P + 2 * _SEARCH_RADIUS + 2, H, W)
    Sb = S + 2
    if min(H, W) < Sb or S < P + 2:
        raise ValueError(f"image {tuple(img0.shape)} too small for fused stereo (needs >= {Sb})")
    c_off = (P - 1) / 2.0
    r = P // 2 + 1

    def _inb(p):
        return (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

    # Shared img0 window centred at the pre-refinement cam0 points.
    sorg0 = _clip_xy(torch.floor(pts0) - (S // 2), 0.0, W - S, H - S)
    big0 = _extract_at_origins(img0, sorg0, S)

    pts0_out = pts0
    accept = None
    if anchor_sp is not None:
        A = anchor_sp.shape[0]
        a_norm = norm if anchor_norm is None else anchor_norm
        tqa = _template_quantities(anchor_sp, P, a_norm)
        Cxa, Cya, Cta = _surfaces_for_norm(big0[:A], tqa, P, a_norm)
        f0a = pts0[:A] - c_off - sorg0[:A]
        fa = _run_iterations(Cxa, Cya, tqa, f0a, ~tqa.good, iters, eps, S, P, Ct=Cta)
        pa = fa + c_off + sorg0[:A]
        oka = tqa.good & _inb(pa) & _inb(pts0[:A])
        corr2 = torch.sum((pa - pts0[:A]) ** 2, dim=1)
        accept = anchor_valid & oka & (corr2 <= anchor_radius**2)
        pts0_out = torch.cat(
            [torch.where(accept[:, None], pa, pts0[:A]), pts0[A:]], dim=0
        )

    # Forward template at the refined positions (the carried-template path).
    sp = _interp_template(img0, pts0_out, P)
    tq = _template_quantities(sp, P, norm)

    # Forward search: one (S+2)-window whose +-1 margins hold the backward
    # template window at any in-range forward result.
    guess2 = guess + (pts0_out - pts0)
    o1 = _clip_xy(torch.floor(guess2) - (S // 2) - 1, 0.0, W - Sb, H - Sb)
    big1 = _extract_at_origins(img1, o1, Sb)
    spatch = big1[:, 1 : 1 + S, 1 : 1 + S]
    so = o1 + 1.0
    Cx, Cy, Ct = _surfaces_for_norm(spatch, tq, P, norm)
    f0 = guess2 - c_off - so
    f = _run_iterations(Cx, Cy, tq, f0, ~tq.good, iters, eps, S, P, Ct=Ct)
    pts1 = f + c_off + so
    okf = tq.good & _inb(pts1) & _inb(pts0_out)
    res = KltResult(pts=pts1, valid=valid_in & okf)

    # Backward round trip: template resampled from big1 at the forward
    # result, search on big0 from the refined cam0 position.
    q = P + 2
    ob = torch.clamp(pts1 - (P + 1) / 2.0 - o1, 0.0, Sb - (P + 3.0))
    sp_b = _sample(_tent_weights(ob[:, 1], q, Sb), big1, _tent_weights(ob[:, 0], q, Sb))
    tqb = _template_quantities(sp_b, P, norm)
    Cxb, Cyb, Ctb = _surfaces_for_norm(big0, tqb, P, norm)
    f0b = pts0_out - c_off - sorg0
    fb = _run_iterations(Cxb, Cyb, tqb, f0b, ~tqb.good, iters, eps, S, P, Ct=Ctb)
    rt = fb + c_off + sorg0
    okb = tqb.good & _inb(rt) & _inb(pts1)
    rt2 = torch.where(
        okb, torch.sum((rt - pts0_out) ** 2, dim=1), torch.full_like(rt[:, 0], float("inf"))
    )
    return pts0_out, accept, res, rt2, sp, tq.min_eig


def _track_level_corr(
    img_prev, img_curr, pts_prev, pts_curr0, win, iters, eps, final_level,
    tmpl_sp=None, want_tmpl=False, norm="none",
):
    """One pyramid level for all N features.  ``tmpl_sp`` skips template
    extraction; ``want_tmpl`` adds the templates to the return; ``norm`` is
    the photometric norm (see ``_template_quantities``)."""
    H, W = img_prev.shape
    P = win
    S = min(win + 2 * _SEARCH_RADIUS + 2, H, W)
    T = P + 4
    if S < P + 2 or min(H, W) < T:
        out = pts_curr0, torch.ones(pts_curr0.shape[0], dtype=torch.bool, device=pts_curr0.device)
        return out + (tmpl_sp,) if want_tmpl else out
    sp = tmpl_sp if tmpl_sp is not None else _interp_template(img_prev, pts_prev, P)
    tq = _template_quantities(sp, P, norm)

    sorg = _clip_xy(torch.floor(pts_curr0) - (S // 2), 0.0, W - S, H - S)
    spatch = _extract_at_origins(img_curr, sorg, S)
    Cx, Cy, Ct = _surfaces_for_norm(spatch, tq, P, norm)

    # Window-origin coordinates, carried unclipped until the first update.
    c_off = (P - 1) / 2.0
    f0 = pts_curr0 - c_off - sorg
    f = _run_iterations(Cx, Cy, tq, f0, ~tq.good, iters, eps, S, P, Ct=Ct)
    pts = f + c_off + sorg

    if not final_level:
        ok = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    else:
        r = win // 2 + 1
        ok = (pts[:, 0] >= r) & (pts[:, 0] < W - r) & (pts[:, 1] >= r) & (pts[:, 1] < H - r)
        ok = ok & (pts_prev[:, 0] >= r) & (pts_prev[:, 0] < W - r)
        ok = ok & (pts_prev[:, 1] >= r) & (pts_prev[:, 1] < H - r)
        ok = tq.good & ok
    return (pts, ok, sp) if want_tmpl else (pts, ok)


def optical_flow_lk_corr_l0(
    img_prev, img_curr, pts_prev, pts_curr_init, valid_in,
    win: int = 15, iters: int = 30, eps: float = 0.01,
    tmpl_sp=None, want_tmpl: bool = False, norm: str = "none",
):
    """Single-level LK with template reuse: ``tmpl_sp`` (N, win+2, win+2)
    must come from an earlier ``want_tmpl=True`` call at the same (image,
    position) pairs.  Returns (KltResult, templates or None)."""
    pts, ok, sp = _track_level_corr(
        img_prev, img_curr, pts_prev, pts_curr_init, win, iters, eps, True,
        tmpl_sp=tmpl_sp, want_tmpl=True, norm=norm,
    )
    res = KltResult(pts=pts, valid=valid_in & ok)
    return (res, sp) if want_tmpl else (res, None)


def optical_flow_pyr_lk_corr(
    pyr_prev: Sequence[torch.Tensor],
    pyr_curr: Sequence[torch.Tensor],
    pts_prev, pts_curr_init, valid_in,
    win: int = 15, iters: int = 30, eps: float = 0.01, norm: str = "none",
) -> KltResult:
    """Pyramidal LK, coarse to fine (calcOpticalFlowPyrLK semantics with an
    initial flow)."""
    L = len(pyr_prev)
    pts = pts_curr_init / 2.0 ** (L - 1)
    valid = valid_in
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        pts, ok = _track_level_corr(
            pyr_prev[lvl], pyr_curr[lvl], pts_prev / s, pts, win, iters, eps, lvl == 0,
            norm=norm,
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0
    return KltResult(pts=pts, valid=valid)
