"""Dense FAST-9/16 corners with per-cell best selection (port of
``msckf_stereo_c_tpu/ops/fast.py``).  Images may carry leading lane axes
((..., H, W)) and points a matching (..., N, 2); each lane is its own
image.

On a CUDA tensor ``detect_grid_corners`` is one launch of the hand-written
kernel ``fast_grid_corners`` (``csrc/fast_grid_corners.cu``): score, arc
test and per-cell pick in one pass over each image.  On a CPU tensor it is
the plain version, ``detect_grid_corners_reference``: the dense score map
(``fast_score_map``), then each tile's first maximum."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .patch_extract import broadcast_image

# Bresenham circle of radius 3 (OpenCV order), (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _has_arc(mask: torch.Tensor) -> torch.Tensor:
    """Contiguous circular run >= 9 along dim -3 of a (..., 16, H, W) mask."""
    m = mask & torch.roll(mask, -1, -3)  # >= 2
    m = m & torch.roll(m, -2, -3)  # >= 4
    m = m & torch.roll(m, -4, -3)  # >= 8
    m = m & torch.roll(mask, -8, -3)  # >= 9
    return torch.any(m, dim=-3)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 response (sum of |I(circle) - I(p)| over the circle
    pixels past the threshold); zero where the segment test fails and on the
    3-pixel border."""
    H, W = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    shifted = torch.stack(
        [padded[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dy, dx in _CIRCLE], dim=-3
    )
    diff = shifted - img[..., None, :, :]
    brighter = diff > threshold
    darker = diff < -threshold
    is_corner = _has_arc(brighter) | _has_arc(darker)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.sum(torch.where(brighter | darker, torch.abs(diff), zero), dim=-3)
    score = torch.where(is_corner, score, zero)
    out = torch.zeros_like(score)
    out[..., 3 : H - 3, 3 : W - 3] = score[..., 3 : H - 3, 3 : W - 3]
    return out


class CellCorners(NamedTuple):
    xy: torch.Tensor  # (..., C, 2) float [x, y]
    score: torch.Tensor  # (..., C)
    valid: torch.Tensor  # (..., C) bool


def detect_grid_corners_reference(
    img: torch.Tensor,
    threshold: float,
    cell: int = 16,
    occupied: torch.Tensor | None = None,
    score_out: torch.Tensor | None = None,
) -> CellCorners:
    """Plain version of ``fast_grid_corners``: the dense score map, then each
    tile's first maximum by ``argmax`` and ``gather``."""
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    Gy, Gx = H // cell, W // cell
    score = fast_score_map(img, threshold)
    if score_out is not None:
        score_out[..., : Gy * cell, : Gx * cell] = score[..., : Gy * cell, : Gx * cell]
    tiles = score[..., : Gy * cell, : Gx * cell].reshape(lead + (Gy, cell, Gx, cell))
    tiles = tiles.transpose(-2, -3).reshape(lead + (Gy, Gx, cell * cell))
    best = torch.argmax(tiles, dim=-1)  # first maximum, as jnp.argmax
    best_score = torch.gather(tiles, -1, best[..., None])[..., 0]
    dev = img.device
    ys = torch.arange(Gy, device=dev)[:, None] * cell + best // cell
    xs = torch.arange(Gx, device=dev)[None, :] * cell + best % cell
    valid = best_score > 0
    if occupied is not None:
        valid = valid & ~occupied
    xy = torch.stack([xs, ys], dim=-1).reshape(lead + (Gy * Gx, 2)).to(img.dtype)
    return CellCorners(xy=xy, score=best_score.reshape(lead + (-1,)), valid=valid.reshape(lead + (-1,)))


def detect_grid_corners(
    img: torch.Tensor,
    threshold: float,
    cell: int = 16,
    occupied: torch.Tensor | None = None,
    score_out: torch.Tensor | None = None,
) -> CellCorners:
    """Best FAST corner per cell x cell tile of each (..., H, W) image;
    ``occupied`` (..., Gy, Gx) masks cells that already hold a track.  A
    (B, H, W) stack that is a broadcast view of one image is scored once.
    ``score_out`` (..., H, W), when given, receives the score map on the
    tiles (rows < Gy * cell, columns < Gx * cell); the rest is left as it
    is."""
    one = broadcast_image(img)
    if one is not None:
        if score_out is not None:
            raise ValueError("score_out takes a stack of distinct images, not a broadcast view")
        c = detect_grid_corners(one, threshold, cell)
        B = img.shape[0]
        valid = c.valid.expand(B, -1)
        if occupied is not None:
            valid = valid & ~occupied.reshape(B, -1)
        return CellCorners(xy=c.xy.expand(B, -1, -1), score=c.score.expand(B, -1), valid=valid)
    if cell < 1:
        raise ValueError(f"cell must be a positive number of pixels, got {cell}")
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    Gy, Gx = H // cell, W // cell
    if occupied is not None and occupied.shape != lead + (Gy, Gx):
        raise ValueError(f"occupied must be {tuple(lead + (Gy, Gx))} for a {tuple(img.shape)} image, "
                         f"got {tuple(occupied.shape)}")
    if score_out is not None and score_out.shape != img.shape:
        raise ValueError(f"score_out must be {tuple(img.shape)}, got {tuple(score_out.shape)}")
    if img.device.type == "cpu":
        return detect_grid_corners_reference(img, threshold, cell, occupied, score_out)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.dtype != torch.float32 or not (score_out is None or score_out.dtype == torch.float32):
        raise TypeError("detect_grid_corners takes a float32 image and score_out")
    if occupied is not None and occupied.dtype != torch.bool:
        raise TypeError("occupied must be a bool mask")
    if any(t is not None and t.device != img.device for t in (occupied, score_out)):
        raise ValueError("image, occupied and score_out must lie on one device")
    if not img.is_contiguous() or not (score_out is None or score_out.is_contiguous()):
        raise ValueError("detect_grid_corners takes a contiguous image and score_out")
    B = math.prod(lead)
    xy = torch.empty(lead + (Gy * Gx, 2), dtype=img.dtype, device=img.device)
    score = torch.empty(lead + (Gy * Gx,), dtype=img.dtype, device=img.device)
    valid = torch.empty(lead + (Gy * Gx,), dtype=torch.bool, device=img.device)
    if B == 0 or Gy * Gx == 0:  # the kernel launches nothing for it, so nothing is counted
        return CellCorners(xy=xy, score=score, valid=valid)
    occupied = None if occupied is None else occupied.contiguous()
    # 16-byte row copies need 16-byte aligned rows: W a multiple of 4 floats.
    vec = int(W % 4 == 0 and img.data_ptr() % 16 == 0)
    _cuda.launch(
        "fast_grid_corners",
        img.data_ptr(), None if occupied is None else occupied.data_ptr(), xy.data_ptr(), score.data_ptr(),
        valid.data_ptr(), None if score_out is None else score_out.data_ptr(), B, H, W, cell, float(threshold),
        vec, torch.cuda.current_stream(img.device).cuda_stream,
    )
    return CellCorners(xy=xy, score=score, valid=valid)


def occupancy_from_points(
    pts_xy: torch.Tensor, valid: torch.Tensor, shape: Tuple[int, int], cell: int = 16
) -> torch.Tensor:
    """(..., Gy, Gx) bool mask of detector cells containing a valid point,
    for points (..., N, 2): one flat ``lane * G + cell`` index."""
    H, W = shape
    Gy, Gx = H // cell, W // cell
    lead = pts_xy.shape[:-2]
    pts = pts_xy.reshape(-1, pts_xy.shape[-2], 2)
    cy = torch.clamp((pts[..., 1] // cell).to(torch.int64), 0, Gy - 1)
    cx = torch.clamp((pts[..., 0] // cell).to(torch.int64), 0, Gx - 1)
    lanes = torch.arange(pts.shape[0], device=pts.device)[:, None]
    count = torch.zeros(pts.shape[0] * Gy * Gx, dtype=torch.int32, device=pts.device)
    count.index_add_(0, (lanes * (Gy * Gx) + cy * Gx + cx).reshape(-1), valid.reshape(-1).to(torch.int32))
    return (count > 0).reshape(lead + (Gy, Gx))
