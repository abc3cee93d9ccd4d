"""Gaussian image pyramid and the 5-tap presmooth (port of
``msckf_stereo_c_tpu/ops/pyramid.py``).

OpenCV pyrDown semantics: separable [1,4,6,4,1]/16 with REFLECT_101 borders,
then factor-2 decimation to (n+1)//2.  The JAX package writes each 1-D pass
as a dense banded GEMM because the TPU's matrix unit favours it.  Images
may carry leading axes ((..., H, W), one lane per sequence); each image is
filtered on its own.

On a CUDA tensor each blurred level is one launch of the hand-written
kernel ``pyramid_level`` (``csrc/pyramid_level.cu``) over every image of
the stack; one launch gives both the full-resolution blur (``smooth5``) and
its decimation (``pyr_down``) of the same input, as the tracker's
presmoothed pyramid wants.  On a CPU tensor it is the plain version,
``pyramid_level_reference``: each pass as five shifted adds over a
reflect-padded view (``F.pad`` mode ``"reflect"`` is REFLECT_101).  The two
agree bit for bit; with the JAX package they agree to f32 rounding.

Under a bf16 precision name (``precision.active_passes()``, the front
end's scope) the operand of each separable pass is rounded as the bf16
passes see it, as the TPU's two GEMMs round theirs: the image before the
row pass, the row-filtered image before the column pass.  The weights 1, 4,
6, 4, 1 over 16 are exact in bf16, and so is an 8-bit image: only the
presmoothed and coarser levels move."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda, precision


def _blur_rows(p: torch.Tensor, n: int, step: int) -> torch.Tensor:
    """5-tap binomial along dim -2 of a 2-padded (..., n+4, W) tensor,
    evaluated at output rows 0, step, 2*step, ... < n."""
    taps = [p[..., t : t + n : step, :] for t in range(5)]
    return (taps[0] + 4.0 * taps[1] + 6.0 * taps[2] + 4.0 * taps[3] + taps[4]) * (1.0 / 16.0)


def _blur2d(img: torch.Tensor, step: int, passes: int) -> torch.Tensor:
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = precision.operand(img.reshape(-1, 1, H, W), passes)
    x = F.pad(x, (0, 0, 2, 2), mode="reflect")
    x = _blur_rows(x, H, step)
    x = F.pad(precision.operand(x, passes), (2, 2, 0, 0), mode="reflect")
    x = _blur_rows(x.transpose(-1, -2), W, step).transpose(-1, -2)
    return x.reshape(lead + x.shape[-2:]).contiguous()


def pyramid_level_reference(
    img: torch.Tensor, full: bool, half: bool, passes: int = 0
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of ``pyramid_level``: the blur of ``img`` at full
    resolution (or None) and at every second row and column (or None), as
    two chains of tensor ops, 18 elementwise and pad launches each."""
    return (_blur2d(img, 1, passes) if full else None, _blur2d(img, 2, passes) if half else None)


def pyramid_level(
    img: torch.Tensor, full: bool = True, half: bool = True
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(smooth5(img) if ``full``, pyr_down(img) if ``half``) of an (..., H,
    W) stack, each None where not asked for, under the scope's passes: one
    kernel launch on a CUDA tensor."""
    passes = precision.active_passes()
    if img.device.type == "cpu":
        return pyramid_level_reference(img, full, half, passes)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pyramid_level takes float32 or float64 images, got {img.dtype}")
    if img.dim() < 2 or min(img.shape[-2:]) < 3:
        raise ValueError(f"pyramid_level takes (..., H, W) images with H, W >= 3, got {tuple(img.shape)}")
    if not (full or half):
        raise ValueError("pyramid_level: ask for the full-resolution level, the decimated one or both")
    precision.check_passes(passes)
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    out_full = torch.empty(img.shape, dtype=img.dtype, device=img.device) if full else None
    out_half = torch.empty(lead + ((H + 1) // 2, (W + 1) // 2), dtype=img.dtype, device=img.device) if half else None
    n = img.numel() // (H * W)
    if n == 0:  # the kernel launches nothing for it, so nothing is counted
        return out_full, out_half
    img = img.contiguous()
    _cuda.launch(
        "pyramid_level", img.data_ptr(), None if out_full is None else out_full.data_ptr(),
        None if out_half is None else out_half.data_ptr(), n, H, W, passes, int(img.dtype == torch.float64),
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    return out_full, out_half


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., (H+1)//2, (W+1)//2)."""
    return pyramid_level(img, full=False, half=True)[1]


def smooth5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur, no decimation (the tracker's
    sensor-noise prefilter, FrontendConfig.presmooth)."""
    return pyramid_level(img, full=True, half=False)[0]


def build_pyramid(img: torch.Tensor, levels: int = 4) -> List[torch.Tensor]:
    """Level 0 is the input image."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def tracker_pyramid(img: torch.Tensor, levels: int, presmooth: bool) -> List[torch.Tensor]:
    """``build_pyramid(img, levels)``, with ``presmooth`` its level 0
    replaced by ``smooth5(img)`` (the coarse levels stay the raw pyrDown
    chain).  Presmoothed, levels 0 and 1 come from one ``pyramid_level``
    call: ``max(levels - 1, 1)`` calls in all, ``levels - 1`` without."""
    if not presmooth:
        return build_pyramid(img, levels)
    smoothed, level1 = pyramid_level(img, full=True, half=levels > 1)
    return [smoothed] + ([] if level1 is None else build_pyramid(level1, levels - 1))


def blank_pyramid(shape: Tuple[int, int], levels: int, dtype=None, device=None) -> List[torch.Tensor]:
    """The tracker pyramid of an all-zero (H, W) image, ``max(levels, 1)``
    levels of zeros (the blur of zeros is zeros), made without a blur."""
    (H, W), pyr = shape, []
    for _ in range(max(levels, 1)):
        pyr.append(torch.zeros((H, W), dtype=dtype, device=device))
        H, W = (H + 1) // 2, (W + 1) // 2
    return pyr
