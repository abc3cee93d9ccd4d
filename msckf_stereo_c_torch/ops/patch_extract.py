"""Window extraction: (N, S, S) windows out of an image at integer origins.

Port of ``msckf_stereo_c_tpu/ops/patch_extract.py``.  ``extract_windows``
launches the hand-written CUDA kernel (``csrc/extract_windows.cu``) for a
CUDA tensor and takes the plain PyTorch version for a CPU tensor.  The
feature axis is flat: an optional per-window image index picks one image of
a (B, H, W) stack, so a batch of sequences can fold into it.

Both versions clamp each origin into [0, W-S] x [0, H-S], and each image
index into [0, B-1]: on the card an out-of-range origin or index would
otherwise read outside the image stack.  Past the far
edge this is the clamp of ``lax.dynamic_slice`` in the JAX package; a
negative start, which no caller passes, goes to 0 here where
``lax.dynamic_slice`` first wraps it.
"""
from __future__ import annotations

import torch

from . import _cuda


def broadcast_image(img: torch.Tensor) -> torch.Tensor | None:
    """The one image of a (B, H, W) stack whose lane axis is a broadcast
    view (stride 0: one image shared by every lane), else None."""
    if img.dim() == 3 and img.shape[0] > 1 and img.stride(0) == 0:
        return img[0]
    return None


def lane_images(img: torch.Tensor, img_index: torch.Tensor | None):
    """(image or stack, per-window image index) for a kernel call: a stack
    that broadcasts one image becomes that image with no index, so a shared
    image is never copied B times (``.contiguous()`` of the view would)."""
    one = broadcast_image(img)
    return (img, img_index) if one is None else (one, None)


def image_stack(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 2:
        return img[None]
    if img.dim() != 3:
        raise ValueError(f"img must be (H, W) or (B, H, W), got {tuple(img.shape)}")
    return img


def image_index_ptr(img_index: torch.Tensor | None, n: int, imgs: torch.Tensor):
    """The device pointer of a kernel's optional int32 (n,) image index
    (None without one), after checking it; shared by the kernels that read
    windows out of a (B, H, W) stack."""
    if img_index is None:
        return None
    if img_index.dtype != torch.int32 or img_index.shape != (n,):
        raise TypeError("img_index must be int32 of shape (N,)")
    if not img_index.is_contiguous() or img_index.device != imgs.device:
        raise ValueError("img_index must be contiguous and on the image's device")
    return img_index.data_ptr()


def extract_windows_reference(
    img: torch.Tensor, origins: torch.Tensor, S: int, img_index: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version: advanced indexing of the clamped windows."""
    imgs = image_stack(img)
    B, H, W = imgs.shape
    ox = origins[:, 0].long().clamp(0, W - S)
    oy = origins[:, 1].long().clamp(0, H - S)
    r = torch.arange(S, device=img.device)
    rows = (oy[:, None] + r)[:, :, None]
    cols = (ox[:, None] + r)[:, None, :]
    if img_index is None:
        b = torch.zeros_like(ox)
    else:
        b = img_index.long().clamp(0, B - 1)
    return imgs[b[:, None, None], rows, cols]


def extract_windows(
    img: torch.Tensor, origins: torch.Tensor, S: int, img_index: torch.Tensor | None = None
) -> torch.Tensor:
    """(N, S, S) windows ``img[b, oy:oy+S, ox:ox+S]`` for int32 origins (N, 2)
    [x, y] and, for a (B, H, W) stack, int32 image indices (N,)."""
    imgs = image_stack(img)
    B, H, W = imgs.shape
    if origins.dim() != 2 or origins.shape[1] != 2:
        raise ValueError(f"origins must be (N, 2), got {tuple(origins.shape)}")
    if not 0 < S <= min(H, W):
        raise ValueError(f"window {S} does not fit a {H}x{W} image")
    if img_index is None and B != 1:
        raise ValueError("a (B, H, W) stack with B > 1 needs img_index")
    if origins.shape[0] == 0:  # the kernel launches nothing for it, so nothing is counted
        return torch.empty((0, S, S), dtype=imgs.dtype, device=imgs.device)
    if imgs.device.type == "cpu":
        return extract_windows_reference(imgs, origins, S, img_index)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or origins.dtype != torch.int32:
        raise TypeError("extract_windows takes a float32 image and int32 origins")
    if not (imgs.is_contiguous() and origins.is_contiguous()):
        raise ValueError("extract_windows takes contiguous tensors")
    if origins.device != imgs.device:
        raise ValueError("image and origins must lie on one device")
    N = origins.shape[0]
    out = torch.empty((N, S, S), dtype=imgs.dtype, device=imgs.device)
    fn = _cuda.kernel_function("extract_windows")
    rc = fn(
        imgs.data_ptr(), origins.data_ptr(), image_index_ptr(img_index, N, imgs),
        out.data_ptr(), N, B, H, W, S, H * W,
        torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _cuda.check_launch("extract_windows", rc)
    _cuda.launch_counts["extract_windows"] += 1
    return out
