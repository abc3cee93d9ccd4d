# Frozen copy of chip_smoke.py at commit 50013dad8c92: the peaks and the
# per-step operation counts, bound_ms, lk_trace, footprint_sectors and
# window_sectors.  footprint_sectors takes the features' image indices of a
# (B, H, W) stack (None, as it was, for one image).
"""The least work an LK launch's inputs need: ``lk_trace`` replays the
loop on the launch's surfaces and returns the cells its steps touch,
``footprint_sectors`` the image sectors under those cells' footprints, and
``bound_ms`` the least time, over the published peaks of one H100 SXM."""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Floating-point operations of one K1 Gauss-Newton step of one feature:
# 4 bilinear weights (8), two 4-tap sums (16), residuals (2), 2x2 solve (6),
# update and clamps (6), convergence test (4).
K1_OPS_PER_STEP = 42
# One K3 step: 4 bilinear weights (8), three 4-tap sums (24), residuals (3),
# the 2x3 product (10), update and clamps (6), convergence test (4).
K3_OPS_PER_STEP = 55
SECTOR_BYTES = 32  # the least the card reads from memory at once


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lk_trace(sc, surfaces, iters: int, eps: float, hi: float):
    """The algorithm of K1 (two surfaces, sc (N, 8)) or K3 (three surfaces,
    sc (N, 12)) in numpy float64: four bilinear taps per surface and step,
    each lane stopping on its own.

    Returns the final points (N, 2), the Gauss-Newton steps of each lane,
    the distinct 32-byte sectors of one (N, K, K) float32 surface that
    those steps read (the same cells of every surface), and the distinct
    cells they read as flat indices (lane * K + y) * K + x.  What the kernel
    must read and compute on given inputs depends on where and how long
    each lane walks: a lane that starts frozen reads no surface at all."""
    import numpy as np

    sc = sc.astype(np.float64)
    surf = [c.astype(np.float64) for c in surfaces]
    n, K, _ = surf[0].shape
    if len(surf) == 2:
        gxx, gxy, gyy = sc[:, 0], sc[:, 1], sc[:, 2]
        det = gxx * gyy - gxy * gxy
        inv_det = 1.0 / np.where(np.abs(det) > 1e-30, det, 1e-30)
        B = np.stack([np.stack([gyy, -gxy], -1), np.stack([-gxy, gxx], -1)], -2) * inv_det[:, None, None]
        t, f0 = sc[:, 3:5], 5
    else:
        B = sc[:, 0:6].reshape(n, 2, 3)
        t, f0 = sc[:, 6:9], 9
    fx, fy = sc[:, f0].copy(), sc[:, f0 + 1].copy()
    conv = sc[:, f0 + 2] > 0.5
    steps = np.zeros(n, np.int64)
    lanes = np.arange(n)
    touched = [np.zeros(0, np.int64)]
    for _ in range(iters):
        act = ~conv
        if not act.any():
            break
        steps += act
        fxs, fys = np.clip(fx, 0, hi), np.clip(fy, 0, hi)
        x0, y0 = np.floor(fxs).astype(int), np.floor(fys).astype(int)
        ax, ay = fxs - x0, fys - y0
        cell = (lanes * K + y0) * K + x0
        touched += [cell[act] + d for d in (0, 1, K, K + 1)]

        def tap(c):
            return ((1 - ay) * (1 - ax) * c[lanes, y0, x0] + (1 - ay) * ax * c[lanes, y0, x0 + 1]
                    + ay * (1 - ax) * c[lanes, y0 + 1, x0] + ay * ax * c[lanes, y0 + 1, x0 + 1])

        b = t - np.stack([tap(c) for c in surf], -1)
        d = np.einsum("nij,nj->ni", B, b)
        fx = np.where(act, np.clip(fx + d[:, 0], 0, hi), fx)
        fy = np.where(act, np.clip(fy + d[:, 1], 0, hi), fy)
        conv = conv | (act & (np.hypot(d[:, 0], d[:, 1]) < eps))
    cells = np.unique(np.concatenate(touched))
    sectors = np.unique(cells * 4 // SECTOR_BYTES).size
    return np.stack([fx, fy], -1), steps, sectors, cells


def footprint_sectors(origins, cells, S: int, P: int, H: int, W: int, img_index=None) -> int:
    """Distinct 32-byte sectors of a float32 (H, W) image that the surface
    cells ``cells`` (flat indices (lane * K + y) * K + x, as ``lk_trace``
    returns them, K = S - P + 1) of the (S, S) windows at ``origins``
    (N, 2) [x, y] read: each cell's correlation reads the (P, P) pixels at
    its window's clamped origin plus (x, y), in the image ``img_index`` of
    its feature of a (B, H, W) stack (image 0 without)."""
    import numpy as np

    K = S - P + 1
    o = np.asarray(origins, np.int64).reshape(-1, 2)
    ox = np.clip(o[:, 0], 0, W - S)
    oy = np.clip(o[:, 1], 0, H - S)
    c = np.asarray(cells, np.int64)
    lane, y, x = c // (K * K), c // K % K, c % K
    b = None if img_index is None else np.asarray(img_index, np.int64).reshape(-1)[lane]
    return window_sectors(np.stack([ox[lane] + x, oy[lane] + y], 1), P, H, W, b)


def window_sectors(origins, S: int, H: int, W: int, img_index=None) -> int:
    """Distinct 32-byte sectors of a float32 (B, H, W) image stack (32-byte
    aligned) under the (S, S) windows at integer ``origins`` (N, 2) [x, y],
    clamped into the image as the kernels clamp them, in the images
    ``img_index`` (N,) (image 0 without)."""
    import numpy as np

    o = np.asarray(origins, np.int64).reshape(-1, 2)
    ox = np.clip(o[:, 0], 0, W - S)
    oy = np.clip(o[:, 1], 0, H - S)
    b = np.zeros_like(ox) if img_index is None else np.asarray(img_index, np.int64)
    first = ((b[:, None] * H + oy[:, None] + np.arange(S)) * W + ox[:, None]) * 4  # (N, S) row starts
    lo = first // SECTOR_BYTES
    hi = (first + 4 * S - 1) // SECTOR_BYTES
    sec = lo[..., None] + np.arange(int((hi - lo).max(initial=0)) + 1)
    return int(np.unique(sec[sec <= hi[..., None]]).size)
