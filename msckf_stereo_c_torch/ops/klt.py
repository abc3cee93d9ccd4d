"""Pyramidal Lucas-Kanade by bilinear gathers (port of
``msckf_stereo_c_tpu/ops/klt.py``): the reference formulation, the
front end's ``klt_impl='gather'`` and, in the port, ``klt_impl='gemm'``.

Per level and feature: a (P+2)^2 template super-patch gathered bilinearly
from the previous image, central-difference gradients and the 2x2 normal
matrix; then exactly ``iters`` inverse-compositional steps, each gathering
the P^2 patch at the current estimate.  A feature freezes once a step is
shorter than ``eps`` or when its template fails the min-eigenvalue gate
(the JAX package's ``lax.scan``).  Coarse levels only refine the guess and
report ok; validity comes from level 0.

The JAX package has no Pallas kernel here, so this is plain PyTorch on the
card too: the loop has a fixed length and reads nothing back to the host.
Lanes fold into the feature axis as in ``klt_corr.py``: an image stack
(B, H, W) with an int32 ``img_index`` (N,) naming each feature's image, a
stack that broadcasts one image read as that image.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .klt_corr import _MIN_EIG_THRESHOLD, KltResult
from .linalg import solve2x2
from .patch_extract import image_stack, lane_images


def _patch_offsets(win: int, pad: int, dtype, device) -> torch.Tensor:
    """(P^2, 2) [dx, dy] grid centred on 0, P = win + 2*pad, row-major;
    made where it is used (a host copy to the card would synchronise)."""
    r = win // 2 + pad
    g = torch.arange(-r, r + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=1)


class _Gather:
    """Bilinear sampling of one image, or of each feature's image of a
    stack, at per-feature point sets (N, M).  Reads clamp into the image
    (x0 to W-2, y0 to H-2) with the unclamped weights, as in JAX."""

    def __init__(self, img: torch.Tensor, img_index: torch.Tensor | None):
        img, idx = lane_images(img, img_index)
        imgs = image_stack(img)
        B, self.H, self.W = imgs.shape
        if idx is None and B != 1:
            raise ValueError("a (B, H, W) stack with B > 1 needs img_index")
        self.flat = imgs.reshape(-1)
        self.base = 0 if idx is None else (idx.to(torch.int64) * (self.H * self.W))[:, None]

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        ax = x - x0
        ay = y - y0
        x0i = torch.clamp(x0.to(torch.int64), 0, self.W - 2)
        y0i = torch.clamp(y0.to(torch.int64), 0, self.H - 2)
        idx = self.base + y0i * self.W + x0i
        f = self.flat
        return (
            f[idx] * (1 - ax) * (1 - ay)
            + f[idx + 1] * ax * (1 - ay)
            + f[idx + self.W] * (1 - ax) * ay
            + f[idx + self.W + 1] * ax * ay
        )


def _track_level(img_prev, img_curr, pts_prev, pts0, win, iters, eps, final_level, img_index):
    """Refine every feature at one pyramid level (inverse-compositional LK:
    template gradients fixed, 2x2 normal equations per step)."""
    N = pts_prev.shape[0]
    P = win
    dt, dev = pts_prev.dtype, pts_prev.device
    prev = _Gather(img_prev, img_index)
    curr = _Gather(img_curr, img_index)
    off = _patch_offsets(win, 0, dt, dev)
    off_g = _patch_offsets(win, 1, dt, dev)

    sp = prev(pts_prev[:, 0:1] + off_g[:, 0], pts_prev[:, 1:2] + off_g[:, 1]).reshape(N, P + 2, P + 2)
    templ = sp[:, 1:-1, 1:-1].reshape(N, -1)
    gx = (0.5 * (sp[:, 1:-1, 2:] - sp[:, 1:-1, :-2])).reshape(N, -1)
    gy = (0.5 * (sp[:, 2:, 1:-1] - sp[:, :-2, 1:-1])).reshape(N, -1)
    gxx = torch.sum(gx * gx, -1)
    gxy = torch.sum(gx * gy, -1)
    gyy = torch.sum(gy * gy, -1)
    G = torch.stack([torch.stack([gxx, gxy], -1), torch.stack([gxy, gyy], -1)], -2)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    good = (0.5 * tr - disc) / (P * P) > _MIN_EIG_THRESHOLD

    pt = pts0
    converged = ~good
    for _ in range(iters):
        patch = curr(pt[:, 0:1] + off[:, 0], pt[:, 1:2] + off[:, 1])
        dI = templ - patch
        b = torch.stack([torch.sum(dI * gx, -1), torch.sum(dI * gy, -1)], -1)
        delta = solve2x2(G, b)
        now = torch.linalg.norm(delta, dim=-1) < eps
        pt = torch.where(converged[:, None], pt, pt + delta)
        converged = converged | now

    if not final_level:
        return pt, torch.ones(N, dtype=torch.bool, device=dev)
    H, W = prev.H, prev.W
    r = win // 2 + 1

    def inb(p):
        return (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

    return pt, good & inb(pt) & inb(pts_prev)


def optical_flow_pyr_lk(
    pyr_prev: Sequence[torch.Tensor],
    pyr_curr: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,
    pts_curr_init: torch.Tensor,
    valid_in: torch.Tensor,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
    img_index: torch.Tensor | None = None,
) -> KltResult:
    """Track points (N, 2) in level-0 pixels through the pyramid, coarse to
    fine, from the initial guesses ``pts_curr_init`` (vikit
    ``optical_flow_multi_level`` semantics); ``img_index`` (N,) picks each
    feature's pyramid out of (B, h, w) stacks."""
    L = len(pyr_prev)
    pts = pts_curr_init / 2.0 ** (L - 1)
    valid = valid_in
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        pts, ok = _track_level(
            pyr_prev[lvl], pyr_curr[lvl], pts_prev / s, pts, win, iters, eps, lvl == 0, img_index
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0
    return KltResult(pts=pts, valid=valid)
