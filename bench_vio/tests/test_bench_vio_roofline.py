"""The frozen least-work count equals ``chip_smoke.py``'s on a small
launch, for both fused LK kernels."""
import numpy as np
import pytest
import torch

import chip_smoke
from msckf_stereo_c_torch.ops import klt_corr as kc

from bench_vio.roofline import lk
from bench_vio.roofline.capture import KERNELS, Launch, count_launch


def _launch(norm, n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    H, W, P = 60, 80, 15
    img_a = torch.rand((H, W), generator=g) * 200
    img_b = torch.roll(img_a, shifts=(1, 2), dims=(0, 1)) + torch.rand((H, W), generator=g)
    pts = torch.rand((n, 2), generator=g) * torch.tensor([W - 30.0, H - 30.0]) + 15
    S = min(P + 2 * kc._SEARCH_RADIUS + 2, H, W)
    tq = kc._template_quantities(kc.extract_template_reference(img_a, pts, P), P, norm)
    sorg = kc._clip_xy(torch.floor(pts) - S // 2, 0.0, W - S, H - S)
    f0 = pts - (P - 1) / 2.0 - sorg
    filters = kc._filters_for_norm(tq, P, norm)
    sc = (kc._k1_sc if len(filters) == 2 else kc._k3_sc)(tq, f0, ~tq.good)
    return img_b, sorg.to(torch.int32), S, tuple(filters), sc, 30, 0.01, float(S - P - 1)


def _chip_smoke_count(img, org, S, filters, sc, iters, eps, hi, ops_per_step):
    """chip_smoke.py's count (align_rows), on the port's plain surfaces."""
    nf, P = len(filters), filters[0].shape[-1]
    H, W = img.shape
    N = org.shape[0]
    K = S - P + 1
    surf = torch.empty((N, nf, K, K))
    ref = kc.lk_corr_align_reference if nf == 2 else kc.lk_corr_align_gain_reference
    ref(img, org, S, *filters, sc, iters, eps, hi, surfaces_out=surf)
    _, steps, _, cells = chip_smoke.lk_trace(sc.numpy(), tuple(surf[:, i].numpy() for i in range(nf)), iters, eps, hi)
    n_step = int((steps > 0).sum())
    n_bytes = (chip_smoke.footprint_sectors(org.numpy(), cells, S, P, H, W) * chip_smoke.SECTOR_BYTES
               + nf * n_step * P * P * 4 + N * 4 * nf * 4 + N * 2 * 4)
    n_ops = int(steps.sum()) * ops_per_step + cells.size * nf * P * P * 2
    return n_bytes, n_ops


@pytest.mark.parametrize("norm,kernel", [("none", "lk_corr_align"), ("gain", "lk_corr_align_gain")])
def test_count_equals_chip_smoke(norm, kernel):
    img, org, S, filters, sc, iters, eps, hi = _launch(norm)
    ops = KERNELS[kernel][1]
    want = _chip_smoke_count(img, org, S, filters, sc, iters, eps, hi, ops)
    got = count_launch(Launch(img, org, S, filters, sc, iters, eps, hi, None), ops)
    assert got == want and want[0] > 0 and want[1] > 0
    # one image of a stack, named by index, counts the same
    idx = torch.zeros(org.shape[0], dtype=torch.int32)
    assert count_launch(Launch(img[None], org, S, filters, sc, iters, eps, hi, idx), ops) == want
    assert lk.bound_ms(*want) == chip_smoke.bound_ms(*want)


def test_stack_footprints_count_each_image():
    cells = np.array([0, 1, 441 + 5])
    org = np.array([[3, 4], [3, 4]])
    one = lk.footprint_sectors(org, cells, 35, 15, 60, 80, np.array([0, 0]))
    two = lk.footprint_sectors(org, cells, 35, 15, 60, 80, np.array([0, 1]))
    assert two > one  # the second feature's footprint lies in another image
    assert lk.footprint_sectors(org, cells, 35, 15, 60, 80) == one
