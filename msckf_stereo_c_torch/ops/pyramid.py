"""Gaussian image pyramid and the 5-tap presmooth (port of
``msckf_stereo_c_tpu/ops/pyramid.py``).

OpenCV pyrDown semantics: separable [1,4,6,4,1]/16 with REFLECT_101 borders,
then factor-2 decimation to (n+1)//2.  The JAX package writes each 1-D pass
as a dense banded GEMM because the TPU's matrix unit favours it; here each
pass is five shifted adds over a reflect-padded view (``F.pad`` mode
``"reflect"`` is REFLECT_101).  The values agree to f32 rounding.  Images
may carry leading axes ((..., H, W), one lane per sequence); each image is
filtered on its own.

Under a bf16 precision name (``precision.active_passes()``, the front
end's scope) the operand of each separable pass is rounded as the bf16
passes see it, as the TPU's two GEMMs round theirs: the image before the
row pass, the row-filtered image before the column pass.  The weights 1, 4,
6, 4, 1 over 16 are exact in bf16, and so is an 8-bit image: only the
presmoothed and coarser levels move."""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import precision


def _blur_rows(p: torch.Tensor, n: int, step: int) -> torch.Tensor:
    """5-tap binomial along dim -2 of a 2-padded (..., n+4, W) tensor,
    evaluated at output rows 0, step, 2*step, ... < n."""
    taps = [p[..., t : t + n : step, :] for t in range(5)]
    return (taps[0] + 4.0 * taps[1] + 6.0 * taps[2] + 4.0 * taps[3] + taps[4]) * (1.0 / 16.0)


def _blur2d(img: torch.Tensor, step: int) -> torch.Tensor:
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    passes = precision.active_passes()
    x = precision.operand(img.reshape(-1, 1, H, W), passes)
    x = F.pad(x, (0, 0, 2, 2), mode="reflect")
    x = _blur_rows(x, H, step)
    x = F.pad(precision.operand(x, passes), (2, 2, 0, 0), mode="reflect")
    x = _blur_rows(x.transpose(-1, -2), W, step).transpose(-1, -2)
    return x.reshape(lead + x.shape[-2:])


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., (H+1)//2, (W+1)//2)."""
    return _blur2d(img, 2).contiguous()


def smooth5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur, no decimation (the tracker's
    sensor-noise prefilter, FrontendConfig.presmooth)."""
    return _blur2d(img, 1).contiguous()


def build_pyramid(img: torch.Tensor, levels: int = 4) -> List[torch.Tensor]:
    """Level 0 is the input image."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr
