"""The traced run's LK launches and their least work.

``capture`` wraps the port's two fused LK wrappers from outside the program
and logs, in launch order, every call that launches a kernel (one with a
feature); while ``active`` is set it also keeps the call's inputs.  After
the profile, ``replay`` pairs the k-th launch of a kernel with the k-th
device event of that kernel (one stream runs them in launch order),
recomputes each kept launch's surfaces with the frozen reference's plain
versions in float32, and counts the least bytes and operations of the
launch as ``chip_smoke.py`` counted them (``lk.lk_trace``,
``lk.footprint_sectors``)."""
from __future__ import annotations

import contextlib
import inspect
from typing import Dict, List, NamedTuple, Optional

import torch

from . import lk

# kernel -> (filters, operations of one LK step of one feature)
KERNELS = {"lk_corr_align": (2, lk.K1_OPS_PER_STEP), "lk_corr_align_gain": (3, lk.K3_OPS_PER_STEP)}


class Launch(NamedTuple):
    img: torch.Tensor
    origins: torch.Tensor
    S: int
    filters: tuple
    sc: torch.Tensor
    iters: int
    eps: float
    hi: float
    img_index: Optional[torch.Tensor]


class Count(NamedTuple):
    n_bytes: int
    n_ops: int
    device_ns: int

    @property
    def bound_ms(self) -> float:
        return lk.bound_ms(self.n_bytes, self.n_ops)[0]


class Capture:
    def __init__(self):
        self.active = False
        self.launches: Dict[str, List[Optional[Launch]]] = {name: [] for name in KERNELS}


@contextlib.contextmanager
def capture():
    """Within the scope the port's ``lk_corr_align`` and
    ``lk_corr_align_gain`` are wrapped; yields the ``Capture`` they log to.
    Restored on exit, also when the scope raises."""
    from msckf_stereo_c_torch.ops import klt_corr

    cap = Capture()
    saved = {name: getattr(klt_corr, name) for name in KERNELS}

    def wrap(name, fn):
        sig = inspect.signature(fn)
        nf = KERNELS[name][0]

        def launch(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if a["origins"].shape[0] > 0:
                keep = None
                if cap.active:
                    filters = tuple(a[k] for k in ("gx", "gy", "gt")[:nf])
                    idx = a["img_index"]
                    keep = Launch(a["img"], a["origins"].clone(), int(a["S"]), tuple(g.clone() for g in filters),
                                  a["sc"].clone(), int(a["iters"]), float(a["eps"]), float(a["hi"]),
                                  None if idx is None else idx.clone())
                cap.launches[name].append(keep)
            return fn(*args, **kwargs)

        return launch

    try:
        for name, fn in saved.items():
            setattr(klt_corr, name, wrap(name, fn))
        yield cap
    finally:
        for name, fn in saved.items():
            setattr(klt_corr, name, fn)


def count_launch(launch: Launch, ops_per_step: int) -> tuple:
    """(bytes, operations) the launch's inputs need: ``chip_smoke.py``'s
    count, on surfaces the frozen reference computes in float32."""
    from ..reference.ops.klt_corr import _corr_surfaces
    from ..reference.ops.patch_extract import extract_windows_reference

    img = launch.img if launch.img.dim() == 3 else launch.img[None]
    _, H, W = img.shape
    nf = len(launch.filters)
    P = launch.filters[0].shape[-1]
    N = launch.origins.shape[0]
    S = launch.S
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        spatch = extract_windows_reference(img, launch.origins, S, launch.img_index)
        gx, gy, *extra = launch.filters
        surfaces = _corr_surfaces(spatch, gx, gy, P, extra=tuple(extra))
        surf = [c.cpu().numpy() for c in surfaces]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del spatch, surfaces
    _, steps, _, cells = lk.lk_trace(launch.sc.cpu().numpy(), tuple(surf), launch.iters, launch.eps, launch.hi)
    n_step = int((steps > 0).sum())
    idx = None if launch.img_index is None else launch.img_index.cpu().numpy()
    n_bytes = (lk.footprint_sectors(launch.origins.cpu().numpy(), cells, S, P, H, W, idx) * lk.SECTOR_BYTES
               + nf * n_step * P * P * 4 + N * 4 * nf * 4 + N * 2 * 4)
    n_ops = int(steps.sum()) * ops_per_step + cells.size * nf * P * P * 2
    return int(n_bytes), int(n_ops)


def device_durations(events, kernel: str) -> List[int]:
    """Durations (ns), in start order, of the device events of ``kernel``."""
    from ..trace.stages import kernel_key

    key = f"{kernel}_kernel("
    return [e.end_ns - e.start_ns for e in sorted(events, key=lambda e: e.start_ns)
            if e.kind == "device" and kernel_key(e.name) == key]


def replay(cap: Capture, events) -> tuple:
    """(per kernel the ``Count`` of each kept launch, per kernel (logged
    launches, device events)).  A kernel whose device events do not pair
    one to one with its logged launches is left out of the first."""
    out, pairs = {}, {}
    for name, launches in cap.launches.items():
        durations = device_durations(events, name)
        pairs[name] = (len(launches), len(durations))
        if not launches or len(durations) != len(launches):
            continue
        counts = []
        for launch, ns in zip(launches, durations):
            if launch is not None:
                counts.append(Count(*count_launch(launch, KERNELS[name][1]), int(ns)))
        if counts:
            out[name] = counts
    return out, pairs
