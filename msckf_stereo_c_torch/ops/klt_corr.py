"""Lucas-Kanade via precomputed correlation surfaces, with the photometric
norms 'none', 'zeromean', 'offset' and 'gain' (port of
``msckf_stereo_c_tpu/ops/klt_corr.py``).

The LK right-hand side is linear in the sampled patch, so each alignment
problem precomputes two (K, K) cross-correlations of the template gradients
with its search window (K = S - P + 1) and every Gauss-Newton step only
interpolates them bilinearly (see the JAX module for the identity).

Kernels on the card (a CPU tensor takes each kernel's plain version), and
the paths that launch them:

- ``lk_corr_align`` (``csrc/lk_corr_align.cu``): search window, both
  surfaces and the LK loop of one two-surface problem ('none',
  'zeromean') in one launch: 7 a frame on the bench path ('none').
- ``lk_corr_align_gain`` (``csrc/lk_corr_align_gain.cu``): the same with
  a third surface and the affine-photometric loop, for every
  three-surface problem ('offset', 'gain'): 7 a frame on the stress path
  ('gain'); under 'anchor_gain' the anchor problem only.
- ``extract_template`` (``csrc/extract_template.cu``): the (P+3) template
  window interpolated as it is copied: 4 a frame on every path.
- ``resample_template`` (``csrc/resample_template.cu``): the fused stereo
  call's backward template, tent-interpolated from the image at the
  forward result: 1 a frame on every path.
- ``lk_corr_iterate`` (K1, ``csrc/lk_corr_iterate.cu``),
  ``lk_corr_iterate_gain`` (K3, ``csrc/lk_corr_iterate_gain.cu``) and
  ``patch_extract.extract_windows`` (K2): the loops alone on precomputed
  surfaces and the window copy; no path launches them any more.

Under a bf16 precision name (``precision.active_passes()``, or a wrapper's
``passes``) the three precision-governed kernels compute what the TPU's
matrix unit computed under the front end's scope: the correlation surfaces
of ``lk_corr_align`` and ``lk_corr_align_gain`` in one or three bf16 passes
(their LK loops stay float32: the Pallas loop has no product), and the tent
blend of ``resample_template`` on rounded weights and pixels.
``extract_template`` is untouched: the TPU built templates from four
elementwise bilinear slices.

Templates always come from the (P+3) window plus four bilinear terms, the
formula the TPU ran; the template carried from the stereo call into the
next temporal call depends on one formula for both.

Batched sequences fold into the feature axis: the LK entry points take an
image ``(H, W)`` or a stack ``(B, H, W)`` with an int32 ``img_index`` (N,)
naming each feature's image, and every kernel still launches once per call
for all B x N features.  A stack that broadcasts one image (stride 0) is
read as that one image.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import _cuda, precision
from .patch_extract import extract_windows_reference, image_index_ptr, image_stack, lane_images

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


def _corr_surfaces(spatch: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, P: int, extra=(), passes: int = 0):
    """(N, K, K) cross-correlations of gx, gy and the ``extra`` per-feature
    filters with each search window, as one depthwise convolution (features
    = channels, F filters each), in ``passes`` bf16 passes (0: float32).
    Returns F strided views into one (N, F, K, K) result."""
    N, S, _ = spatch.shape
    filters = (gx, gy) + tuple(extra)
    nf = len(filters)
    weight = torch.stack(filters, dim=1).reshape(nf * N, 1, P, P)
    if passes:
        out = precision.conv2d(spatch[None], weight, groups=N, passes=passes)
    else:
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


def _filters_for_norm(tq: TemplateQ, P: int, norm: str):
    """The correlation filters (N, P, P) of one alignment problem under
    ``norm``: (gx, gy) for 'none', the mean-centred pair for 'zeromean',
    (gx, gy, ones) for 'offset' (the box-sum surface) and the mean-centred
    pair with the zero-mean template for 'gain'.  The zero-mean correction
    of 'zeromean' and 'gain' folds into mean-centred gradient filters by
    linearity."""
    if norm == "none":
        return tq.gx, tq.gy
    if norm == "offset":
        return tq.gx, tq.gy, torch.ones_like(tq.gx)
    gxc, gyc = _centred_filters(tq, P)
    return (gxc, gyc) if norm == "zeromean" else (gxc, gyc, tq.tmpl_c)


def _surfaces_for_norm(spatch: torch.Tensor, tq: TemplateQ, P: int, norm: str):
    """(Cx, Cy, Ct) for one alignment problem under ``norm``: Ct is the
    box-sum surface for 'offset', the zero-mean-template surface for 'gain'
    and None otherwise."""
    gx, gy, *extra = _filters_for_norm(tq, P, norm)
    surfaces = _corr_surfaces(spatch, gx, gy, P, extra=tuple(extra))
    return surfaces if extra else surfaces + (None,)


def _centred_filters(tq: TemplateQ, P: int):
    """Mean-centred gradient filters: the zero-mean correction of
    'zeromean' and 'gain' folded into the surfaces by linearity."""
    n = float(P * P)
    return tq.gx - (tq.sgx / n)[:, None, None], tq.gy - (tq.sgy / n)[:, None, None]


@precision.exact
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
    if N == 0:  # the kernel launches nothing for it, so nothing is counted
        return torch.empty((0, 2), dtype=sc.dtype, device=sc.device)
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


@precision.exact
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


def _align_smem_bytes(S: int, P: int, nf: int = 2, passes: int = 0) -> int:
    """Shared memory of one ``lk_corr_align`` (``nf`` = 2 filters) or
    ``lk_corr_align_gain`` (3) block: the window at a row pitch of the least
    multiple of 4 above S + 3 floats (``window_pitch`` in both sources), the
    taps of the filters and the cells of the surfaces, interleaved as float2
    or float4.  Three bf16 passes keep the window and the taps twice (hi
    and lo)."""
    K = S - P + 1
    copies = 2 if passes == 3 else 1
    return copies * (4 * S * (((S + 3) | 3) + 1) + (8 if nf == 2 else 16) * P * P) + (8 if nf == 2 else 16) * K * K


@precision.exact
def lk_corr_align_reference(
    img: torch.Tensor, origins: torch.Tensor, S: int, gx: torch.Tensor, gy: torch.Tensor,
    sc: torch.Tensor, iters: int, eps: float, hi: float,
    img_index: torch.Tensor | None = None, surfaces_out: torch.Tensor | None = None, passes: int = 0,
) -> torch.Tensor:
    """Plain version of ``lk_corr_align``: the composition it replaces,
    ``extract_windows_reference`` -> ``_corr_surfaces`` (in ``passes``
    bf16 passes) -> ``lk_corr_iterate_reference`` (float32 in every mode:
    the loop has no product)."""
    P = gx.shape[-1]
    spatch = extract_windows_reference(img, origins, S, img_index)
    Cx, Cy = _corr_surfaces(spatch, gx, gy, P, passes=passes)
    if surfaces_out is not None:
        surfaces_out.copy_(torch.stack([Cx, Cy], dim=1))
    return lk_corr_iterate_reference(sc, Cx, Cy, iters, eps, hi)


@precision.exact
def lk_corr_align_gain_reference(
    img: torch.Tensor, origins: torch.Tensor, S: int, gx: torch.Tensor, gy: torch.Tensor,
    gt: torch.Tensor, sc: torch.Tensor, iters: int, eps: float, hi: float,
    img_index: torch.Tensor | None = None, surfaces_out: torch.Tensor | None = None, passes: int = 0,
) -> torch.Tensor:
    """Plain version of ``lk_corr_align_gain``: the composition it replaces,
    ``extract_windows_reference`` -> ``_corr_surfaces`` with a third filter
    (in ``passes`` bf16 passes) -> ``lk_corr_iterate_gain_reference``."""
    P = gx.shape[-1]
    spatch = extract_windows_reference(img, origins, S, img_index)
    Cx, Cy, Ct = _corr_surfaces(spatch, gx, gy, P, extra=(gt,), passes=passes)
    if surfaces_out is not None:
        surfaces_out.copy_(torch.stack([Cx, Cy, Ct], dim=1))
    return lk_corr_iterate_gain_reference(sc, Cx, Cy, Ct, iters, eps, hi)


def _launch_align(name, reference, img, origins, S, filters, sc, iters, eps, hi, img_index, surfaces_out, passes):
    """Shared wrapper of ``lk_corr_align`` (two filters, sc (N, 8)) and
    ``lk_corr_align_gain`` (three, sc (N, 12)): checks the inputs, sends CPU
    tensors to ``reference`` and launches the kernel ``name`` on CUDA
    tensors (or raises).  ``passes`` None takes the scope's pass count."""
    passes = precision.active_passes() if passes is None else passes
    precision.check_passes(passes)
    imgs = image_stack(img)
    B, H, W = imgs.shape
    N = origins.shape[0]
    nf = len(filters)
    P = filters[0].shape[-1]
    K = S - P + 1
    if origins.shape != (N, 2) or sc.shape != (N, 4 * nf):
        raise ValueError(f"{name}: origins (N, 2) and sc (N, {4 * nf}) expected")
    if any(g.shape != (N, P, P) for g in filters):
        raise ValueError(f"{name}: {nf} filters (N, P, P) expected")
    if not (P < S <= min(H, W)):
        raise ValueError(f"{name}: window {S} must exceed P={P} and fit a {H}x{W} image")
    if not 0.0 <= hi <= K - 2:
        raise ValueError(f"hi={hi} must lie in [0, K-2] so all four taps stay in range")
    if _align_smem_bytes(S, P, nf, passes) > 48 * 1024:
        raise ValueError(f"{name}: S={S}, P={P} need more than 48 KB of shared memory")
    if img_index is None and B != 1:
        raise ValueError("a (B, H, W) stack with B > 1 needs img_index")
    if surfaces_out is not None and surfaces_out.shape != (N, nf, K, K):
        raise ValueError(f"{name}: surfaces_out (N, {nf}, {K}, {K}) expected")
    if N == 0:  # the kernel launches nothing for it, so nothing is counted
        return torch.empty((0, 2), dtype=sc.dtype, device=sc.device)
    if imgs.device.type == "cpu":
        return reference(imgs, origins, S, *filters, sc, iters, eps, hi, img_index, surfaces_out, passes)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    tensors = (imgs, *filters, sc) + (() if surfaces_out is None else (surfaces_out,))
    if any(t.dtype != torch.float32 for t in tensors) or origins.dtype != torch.int32:
        raise TypeError(f"{name} takes float32 tensors and int32 origins")
    if any(t.device != imgs.device for t in tensors + (origins,)):
        raise ValueError(f"{name} inputs must lie on one device")
    if not imgs.is_contiguous() or not (surfaces_out is None or surfaces_out.is_contiguous()):
        raise ValueError(f"{name} takes a contiguous image and surfaces_out")
    # The per-feature inputs are small; filters of a resampled template
    # (the backward problem) may come in a permuted layout.
    origins, sc = origins.contiguous(), sc.contiguous()
    filters = tuple(g.contiguous() for g in filters)
    out = torch.empty((N, 2), dtype=sc.dtype, device=sc.device)
    # 16-byte row copies need 16-byte aligned rows: W a multiple of 4 floats.
    vec = int(W % 4 == 0 and imgs.data_ptr() % 16 == 0)
    fn = _cuda.kernel_function(name)
    rc = fn(
        imgs.data_ptr(), origins.data_ptr(), image_index_ptr(img_index, N, imgs),
        *(g.data_ptr() for g in filters), sc.data_ptr(), out.data_ptr(),
        None if surfaces_out is None else surfaces_out.data_ptr(),
        N, B, H, W, H * W, S, P, int(iters), float(eps), float(hi), vec, passes,
        torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _cuda.check_launch(name, rc)
    _cuda.launch_counts[name] += 1
    return out


def lk_corr_align(
    img: torch.Tensor, origins: torch.Tensor, S: int, gx: torch.Tensor, gy: torch.Tensor,
    sc: torch.Tensor, iters: int, eps: float, hi: float,
    img_index: torch.Tensor | None = None, surfaces_out: torch.Tensor | None = None, passes: int | None = None,
) -> torch.Tensor:
    """One two-surface LK problem per feature in one launch: the (S, S)
    search window at int32 ``origins`` (N, 2) [x, y] of ``img`` ((H, W), or
    (B, H, W) with int32 ``img_index`` (N,)), its correlation surfaces with
    the filters ``gx``, ``gy`` (N, P, P), and up to ``iters`` LK steps from
    sc (N, 8) in K1's layout.  Returns the final window-origin coordinates
    f (N, 2), each clamped to [0, hi]; ``surfaces_out`` (N, 2, K, K), when
    given, receives the surfaces.  The surfaces take ``passes`` bf16
    passes (None: the scope's, ``precision.active_passes()``); the loop
    is float32."""
    return _launch_align("lk_corr_align", lk_corr_align_reference, img, origins, S, (gx, gy), sc,
                         iters, eps, hi, img_index, surfaces_out, passes)


def lk_corr_align_gain(
    img: torch.Tensor, origins: torch.Tensor, S: int, gx: torch.Tensor, gy: torch.Tensor,
    gt: torch.Tensor, sc: torch.Tensor, iters: int, eps: float, hi: float,
    img_index: torch.Tensor | None = None, surfaces_out: torch.Tensor | None = None, passes: int | None = None,
) -> torch.Tensor:
    """One three-surface LK problem per feature in one launch: as
    ``lk_corr_align``, with a third filter ``gt`` (N, P, P) (ones for
    'offset', the zero-mean template for 'gain') and up to ``iters``
    affine-photometric steps from sc (N, 12) in K3's layout.  Returns f
    (N, 2), each clamped to [0, hi]; ``surfaces_out`` (N, 3, K, K), when
    given, receives the surfaces; ``passes`` as for ``lk_corr_align``."""
    return _launch_align("lk_corr_align_gain", lk_corr_align_gain_reference, img, origins, S, (gx, gy, gt),
                         sc, iters, eps, hi, img_index, surfaces_out, passes)


def _k1_sc(tq: TemplateQ, f0, conv0) -> torch.Tensor:
    """K1's per-feature scalars (N, 8) = (gxx, gxy, gyy, tgx, tgy, f0x, f0y,
    converged0)."""
    return torch.stack(
        [tq.G[:, 0, 0], tq.G[:, 0, 1], tq.G[:, 1, 1], tq.tgx, tq.tgy,
         f0[:, 0], f0[:, 1], conv0.to(f0.dtype)],
        dim=-1,
    )


def _k3_sc(tq: TemplateQ, f0, conv0) -> torch.Tensor:
    """K3's per-feature scalars (N, 12) = (B00, B01, B02, B10, B11, B12,
    tgx, tgy, st2, f0x, f0y, converged0)."""
    B = tq.Binv
    return torch.stack(
        [B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1], B[:, 1, 2],
         tq.tgx, tq.tgy, tq.st2, f0[:, 0], f0[:, 1], conv0.to(f0.dtype)],
        dim=-1,
    )


def _align(img, org, S, tq: TemplateQ, f0, iters, eps, P, norm, img_index=None):
    """Converged window-origin coordinates f (N, 2) of one alignment whose
    (S, S) search windows lie at the integer-valued float origins ``org`` of
    ``img`` (or of the images ``img_index`` of a stack), in one launch:
    ``lk_corr_align`` for a two-surface norm, ``lk_corr_align_gain`` for a
    three-surface one.  Lanes whose template fails the quality gate start
    frozen."""
    filters = _filters_for_norm(tq, P, norm)
    hi = float(S - P - 1)
    org = org.to(torch.int32)
    if len(filters) == 2:
        return lk_corr_align(img, org, S, *filters, _k1_sc(tq, f0, ~tq.good), iters, eps, hi, img_index)
    return lk_corr_align_gain(img, org, S, *filters, _k3_sc(tq, f0, ~tq.good), iters, eps, hi, img_index)


def _template_geometry(pts, P, H, W):
    """Origins (N, 2) of the (P+3) template windows at ``pts``, floor(pts) -
    (P+1)//2 clipped into the image, and the offsets pts - (P+1)/2 - origin
    clipped into [0, 1]."""
    Tq = P + 3
    torg = _clip_xy(torch.floor(pts) - (P + 1) // 2, 0.0, W - Tq, H - Tq)
    return torg, torch.clamp(pts - (P + 1) / 2.0 - torg, 0.0, 1.0)


def _blend_template(tpatch, a, P):
    """Bilinear interpolation of (N, P+3, P+3) windows at offsets a (N, 2)
    as four static slices."""
    q = P + 2
    ax = a[:, 0][:, None, None]
    ay = a[:, 1][:, None, None]
    return (
        tpatch[:, :q, :q] * (1 - ax) * (1 - ay)
        + tpatch[:, :q, 1 : q + 1] * ax * (1 - ay)
        + tpatch[:, 1 : q + 1, :q] * (1 - ax) * ay
        + tpatch[:, 1 : q + 1, 1 : q + 1] * ax * ay
    )


def extract_template_reference(img, pts, P, img_index=None):
    """Plain version of ``extract_template``: the (P+3) windows by
    ``extract_windows_reference``, then four bilinear slices."""
    imgs = image_stack(img)
    _, H, W = imgs.shape
    torg, a = _template_geometry(pts, P, H, W)
    return _blend_template(extract_windows_reference(imgs, torg.to(torch.int32), P + 3, img_index), a, P)


def extract_template(
    img: torch.Tensor, pts: torch.Tensor, P: int, img_index: torch.Tensor | None = None
) -> torch.Tensor:
    """(N, P+2, P+2) interpolated template super-patches at float32 points
    ``pts`` (N, 2) [x, y] of ``img`` ((H, W), or (B, H, W) with int32
    ``img_index`` (N,)): the (P+3) window at floor(pts - (P+1)/2) holds the
    fractional offset in [0, 1), so bilinear interpolation is four
    neighbouring taps."""
    imgs = image_stack(img)
    B, H, W = imgs.shape
    N = pts.shape[0]
    if pts.shape != (N, 2):
        raise ValueError(f"pts must be (N, 2), got {tuple(pts.shape)}")
    if not 0 < P + 3 <= min(H, W):
        raise ValueError(f"template window {P + 3} does not fit a {H}x{W} image")
    if img_index is None and B != 1:
        raise ValueError("a (B, H, W) stack with B > 1 needs img_index")
    if N == 0:  # the kernel launches nothing for it, so nothing is counted
        return torch.empty((0, P + 2, P + 2), dtype=imgs.dtype, device=imgs.device)
    if imgs.device.type == "cpu":
        return extract_template_reference(imgs, pts, P, img_index)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError("extract_template takes a float32 image and float32 points")
    if pts.device != imgs.device:
        raise ValueError("image and points must lie on one device")
    if not imgs.is_contiguous():
        raise ValueError("extract_template takes a contiguous image")
    pts = pts.contiguous()
    out = torch.empty((N, P + 2, P + 2), dtype=imgs.dtype, device=imgs.device)
    fn = _cuda.kernel_function("extract_template")
    rc = fn(
        imgs.data_ptr(), pts.data_ptr(), image_index_ptr(img_index, N, imgs), out.data_ptr(),
        N, B, H, W, H * W, P, torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _cuda.check_launch("extract_template", rc)
    _cuda.launch_counts["extract_template"] += 1
    return out


@precision.exact
def resample_template_reference(img, pts, origins, Sb, P, img_index=None, passes=0):
    """Plain version of ``resample_template``: the expression it replaces,
    the (Sb, Sb) block by ``extract_windows_reference`` and the tent-weight
    ``einsum``.  Under ``passes`` bf16 passes its three operands (the two
    weight matrices and the pixels) are rounded as the passes see them
    (``precision.operand``) and the einsum runs in float32, the
    intermediate product unrounded: the JAX package's ``_sample`` under its
    bf16 compute dtype (``msckf_stereo_c_tpu/ops/klt_gemm.py:48-56``)."""
    q = P + 2
    ob = torch.clamp(pts - (P + 1) / 2.0 - origins.to(pts.dtype), 0.0, Sb - (P + 3.0))
    block = extract_windows_reference(img, origins, Sb, img_index)
    Wy, Wx = _tent_weights(ob[:, 1], q, Sb), _tent_weights(ob[:, 0], q, Sb)
    if passes:
        Wy, block, Wx = (precision.operand(x, passes) for x in (Wy, block, Wx))
    return _sample(Wy, block, Wx)


def resample_template(
    img: torch.Tensor, pts: torch.Tensor, origins: torch.Tensor, Sb: int, P: int,
    img_index: torch.Tensor | None = None, passes: int | None = None,
) -> torch.Tensor:
    """(N, P+2, P+2) template super-patches at float32 points ``pts``
    (N, 2) [x, y] resampled from the (Sb, Sb) blocks at int32 ``origins``
    (N, 2) of ``img`` ((H, W), or (B, H, W) with int32 ``img_index``
    (N,)): ``ob = clamp(pts - (P+1)/2 - origins, 0, Sb - (P+3))`` and
    ``Wy(ob_y) . block . Wx(ob_x)^T`` with tent weights.  The kernel reads
    only the (P+3) window of the block that the weights touch, and returns
    the layout the plain version's einsum returns (each template stored
    transposed), so that reductions over the templates sum in the same
    order on both.  The weights and pixels take ``passes`` bf16 passes
    (None: the scope's)."""
    passes = precision.active_passes() if passes is None else passes
    precision.check_passes(passes)
    imgs = image_stack(img)
    B, H, W = imgs.shape
    N = pts.shape[0]
    if pts.shape != (N, 2) or origins.shape != (N, 2):
        raise ValueError("resample_template: pts (N, 2) and origins (N, 2) expected")
    if not 0 < P + 3 <= Sb <= min(H, W):
        raise ValueError(f"resample_template: block {Sb} must hold the window {P + 3} and fit a {H}x{W} image")
    if img_index is None and B != 1:
        raise ValueError("a (B, H, W) stack with B > 1 needs img_index")
    if N == 0:  # the kernel launches nothing for it, so nothing is counted
        return torch.empty((0, P + 2, P + 2), dtype=imgs.dtype, device=imgs.device)
    if imgs.device.type == "cpu":
        return resample_template_reference(imgs, pts, origins, Sb, P, img_index, passes)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or pts.dtype != torch.float32 or origins.dtype != torch.int32:
        raise TypeError("resample_template takes a float32 image and points and int32 origins")
    if pts.device != imgs.device or origins.device != imgs.device:
        raise ValueError("resample_template inputs must lie on one device")
    if not imgs.is_contiguous():
        raise ValueError("resample_template takes a contiguous image")
    pts, origins = pts.contiguous(), origins.contiguous()
    out = torch.empty((N, P + 2, P + 2), dtype=imgs.dtype, device=imgs.device).transpose(1, 2)
    fn = _cuda.kernel_function("resample_template")
    rc = fn(
        imgs.data_ptr(), pts.data_ptr(), origins.data_ptr(), image_index_ptr(img_index, N, imgs),
        out.data_ptr(), N, B, H, W, H * W, Sb, P, passes, torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _cuda.check_launch("resample_template", rc)
    _cuda.launch_counts["resample_template"] += 1
    return out


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
    img_index: torch.Tensor | None = None,
):
    """Fused full-resolution stereo fine level: optional anchor-template
    refinement of the first A lanes of ``pts0``, forward LK img0 -> img1 and
    the backward left-right round trip, sharing window extractions (see the
    JAX original for the geometry).  ``norm`` is the photometric norm of the
    forward and backward problems, ``anchor_norm`` (default ``norm``) the
    anchor's; ``img_index`` (N,) picks each feature's image pair out of
    (B, H, W) stacks.  Returns (pts0_out, anchor_accept (A,)
    or None, KltResult forward, rt2 (N,) round-trip squared error, +inf
    where the backward track is invalid, forward templates (N, P+2, P+2),
    forward-template min_eig (N,))."""
    H, W = img0.shape[-2:]
    img0, idx0 = lane_images(img0, img_index)
    img1, idx1 = lane_images(img1, img_index)
    P = win
    S = min(P + 2 * _SEARCH_RADIUS + 2, H, W)
    Sb = S + 2
    if min(H, W) < Sb or S < P + 2:
        raise ValueError(f"image {tuple(img0.shape)} too small for fused stereo (needs >= {Sb})")
    c_off = (P - 1) / 2.0
    r = P // 2 + 1

    def _inb(p):
        return (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

    # Search windows on img0 centred at the pre-refinement cam0 points,
    # shared by the anchor and backward problems (each launch reads its own).
    sorg0 = _clip_xy(torch.floor(pts0) - (S // 2), 0.0, W - S, H - S)
    a_norm = norm if anchor_norm is None else anchor_norm

    pts0_out = pts0
    accept = None
    if anchor_sp is not None:
        A = anchor_sp.shape[0]
        tqa = _template_quantities(anchor_sp, P, a_norm)
        f0a = pts0[:A] - c_off - sorg0[:A]
        fa = _align(img0, sorg0[:A], S, tqa, f0a, iters, eps, P, a_norm, None if idx0 is None else idx0[:A])
        pa = fa + c_off + sorg0[:A]
        oka = tqa.good & _inb(pa) & _inb(pts0[:A])
        corr2 = torch.sum((pa - pts0[:A]) ** 2, dim=1)
        accept = anchor_valid & oka & (corr2 <= anchor_radius**2)
        pts0_out = torch.cat(
            [torch.where(accept[:, None], pa, pts0[:A]), pts0[A:]], dim=0
        )

    # Forward template at the refined positions (the carried-template path).
    sp = extract_template(img0, pts0_out, P, idx0)
    tq = _template_quantities(sp, P, norm)

    # Forward search: the inner (S, S) part of an (S+2)-block at o1 whose
    # +-1 margins hold the backward template window at any in-range forward
    # result.
    guess2 = guess + (pts0_out - pts0)
    o1 = _clip_xy(torch.floor(guess2) - (S // 2) - 1, 0.0, W - Sb, H - Sb)
    so = o1 + 1.0
    f0 = guess2 - c_off - so
    f = _align(img1, so, S, tq, f0, iters, eps, P, norm, idx1)
    pts1 = f + c_off + so
    okf = tq.good & _inb(pts1) & _inb(pts0_out)
    res = KltResult(pts=pts1, valid=valid_in & okf)

    # Backward round trip: template resampled from the (S+2)-block at the
    # forward result, search in the img0 windows at sorg0 from the refined
    # cam0 position.
    sp_b = resample_template(img1, pts1, o1.to(torch.int32), Sb, P, idx1)
    tqb = _template_quantities(sp_b, P, norm)
    f0b = pts0_out - c_off - sorg0
    fb = _align(img0, sorg0, S, tqb, f0b, iters, eps, P, norm, idx0)
    rt = fb + c_off + sorg0
    okb = tqb.good & _inb(rt) & _inb(pts1)
    rt2 = torch.where(
        okb, torch.sum((rt - pts0_out) ** 2, dim=1), torch.full_like(rt[:, 0], float("inf"))
    )
    return pts0_out, accept, res, rt2, sp, tq.min_eig


def _track_level_corr(
    img_prev, img_curr, pts_prev, pts_curr0, win, iters, eps, final_level,
    tmpl_sp=None, want_tmpl=False, norm="none", img_index=None,
):
    """One pyramid level for all N features.  ``tmpl_sp`` skips template
    extraction; ``want_tmpl`` adds the templates to the return; ``norm`` is
    the photometric norm (see ``_template_quantities``); ``img_index`` (N,)
    picks each feature's images out of (B, H, W) stacks."""
    H, W = img_prev.shape[-2:]
    img_prev, idx_prev = lane_images(img_prev, img_index)
    img_curr, idx_curr = lane_images(img_curr, img_index)
    P = win
    S = min(win + 2 * _SEARCH_RADIUS + 2, H, W)
    T = P + 4
    if S < P + 2 or min(H, W) < T:
        out = pts_curr0, torch.ones(pts_curr0.shape[0], dtype=torch.bool, device=pts_curr0.device)
        return out + (tmpl_sp,) if want_tmpl else out
    sp = tmpl_sp if tmpl_sp is not None else extract_template(img_prev, pts_prev, P, idx_prev)
    tq = _template_quantities(sp, P, norm)

    sorg = _clip_xy(torch.floor(pts_curr0) - (S // 2), 0.0, W - S, H - S)
    # Window-origin coordinates, carried unclipped until the first update.
    c_off = (P - 1) / 2.0
    f0 = pts_curr0 - c_off - sorg
    f = _align(img_curr, sorg, S, tq, f0, iters, eps, P, norm, idx_curr)
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
    img_index: torch.Tensor | None = None,
):
    """Single-level LK with template reuse: ``tmpl_sp`` (N, win+2, win+2)
    must come from an earlier ``want_tmpl=True`` call at the same (image,
    position) pairs.  Returns (KltResult, templates or None)."""
    pts, ok, sp = _track_level_corr(
        img_prev, img_curr, pts_prev, pts_curr_init, win, iters, eps, True,
        tmpl_sp=tmpl_sp, want_tmpl=True, norm=norm, img_index=img_index,
    )
    res = KltResult(pts=pts, valid=valid_in & ok)
    return (res, sp) if want_tmpl else (res, None)


def optical_flow_pyr_lk_corr(
    pyr_prev: Sequence[torch.Tensor],
    pyr_curr: Sequence[torch.Tensor],
    pts_prev, pts_curr_init, valid_in,
    win: int = 15, iters: int = 30, eps: float = 0.01, norm: str = "none",
    img_index: torch.Tensor | None = None,
) -> KltResult:
    """Pyramidal LK, coarse to fine (calcOpticalFlowPyrLK semantics with an
    initial flow); ``img_index`` (N,) picks each feature's pyramid out of
    (B, H, W) stacks."""
    L = len(pyr_prev)
    pts = pts_curr_init / 2.0 ** (L - 1)
    valid = valid_in
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        pts, ok = _track_level_corr(
            pyr_prev[lvl], pyr_curr[lvl], pts_prev / s, pts, win, iters, eps, lvl == 0,
            norm=norm, img_index=img_index,
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0
    return KltResult(pts=pts, valid=valid)
