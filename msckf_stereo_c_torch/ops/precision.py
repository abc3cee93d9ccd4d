"""The bf16 matmul precisions: one or three bf16 passes per float32 product.

The TPU's matrix unit multiplies bf16 values.  Under the precision name
``'bfloat16'`` a float32 product takes one pass, under ``'bfloat16_3x'``
three (the JAX package's ``config.py`` names them).  With ``r(x)`` the
float32 ``x`` rounded to the nearest bf16 (ties to even) and back:

- one pass:    ``sum r(a) * r(b)``, accumulated in float32;
- three passes: with ``hi = r(a)`` and ``lo = r(a - hi)``,
  ``hi_a hi_b + hi_a lo_b + lo_a hi_b`` (about 16 mantissa bits).

A product of two bf16 values is exact in float32, so only the order of the
sums is free.  Float64 and integer products are left as they are, as on the
TPU.

On the card a product is one cuBLAS bf16 GEMM with float32 output
(``torch.bmm(..., out_dtype=torch.float32)``), the three passes side by
side on its summed axis; on the CPU it is the float32 GEMM of the parts.
A convolution on the card goes through ``unfold`` to the same batched
GEMM.

``products(passes)`` sets the pass count for a block of code.  While it is
1 or 3, a ``TorchFunctionMode`` routes every ``@``, ``matmul``, ``mm``,
``bmm``, ``mv``, ``dot``, ``einsum`` and ``conv2d`` on float32
tensors through the helpers below, so the filter's and the tracker's
products need no edit of their own.  ``config.matmul_precision_scope``
opens it for a precision name; functions that state their own products
(the kernels' plain versions) run under ``exact``.
"""
from __future__ import annotations

import contextlib
import functools
import string

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# Pass count of each precision name; every other name is 0 (float32).
PASSES = {"bfloat16": 1, "bfloat16_3x": 3}

_passes = 0  # the pass count of the innermost ``products`` block
_mode = None  # the installed routing mode, while a block with passes > 0 is open


def passes_of(precision: str) -> int:
    return PASSES.get(precision, 0)


def active_passes() -> int:
    """The pass count of the innermost open ``products`` block (0: float32)."""
    return _passes


def check_passes(passes: int) -> None:
    if passes not in (0, 1, 3):
        raise ValueError(f"passes={passes} must be 0, 1 or 3")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 with round-to-nearest-even -> float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def split_bf16(x: torch.Tensor):
    """(hi, lo) = (r(x), r(x - r(x))), both float32 holding bf16 values."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def operand(x: torch.Tensor, passes: int) -> torch.Tensor:
    """``x`` as the passes see it: r(x) for one pass, hi + lo (exact in
    float32) for three, ``x`` itself for none or a non-float32 tensor."""
    check_passes(passes)
    if passes == 0 or x.dtype != torch.float32:
        return x
    hi, lo = split_bf16(x)
    return hi if passes == 1 else hi + lo


@contextlib.contextmanager
def _direct():
    """The helpers' own torch calls are not routed again."""
    global _passes
    prev, _passes = _passes, 0
    try:
        yield
    finally:
        _passes = prev


def exact(fn):
    """Run ``fn`` with the pass count at 0: the products it computes are
    the ones it states (a kernel's plain version names its passes)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _direct():
            return fn(*args, **kwargs)

    return wrapper


def _applies(passes: int, *xs) -> bool:
    return passes != 0 and all(isinstance(x, torch.Tensor) and x.dtype == torch.float32 for x in xs)


def _parts(x: torch.Tensor, passes: int):
    """(hi,) or (hi, lo) of float32 ``x``: bf16 tensors on the card,
    float32 ones on the CPU."""
    if x.device.type == "cuda":
        hi = x.to(torch.bfloat16)
        return (hi,) if passes == 1 else (hi, (x - hi.to(torch.float32)).to(torch.bfloat16))
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return (round_bf16(x),) if passes == 1 else split_bf16(x)


def _sum_passes(pair_fn, a, b, passes: int):
    """sum of ``pair_fn`` over the part pairs of the passes, small terms
    first: (lo_a, hi_b), (hi_a, lo_b), (hi_a, hi_b)."""
    pa, pb = _parts(a, passes), _parts(b, passes)
    pairs = [(pa[0], pb[0])] if passes == 1 else [(pa[1], pb[0]), (pa[0], pb[1]), (pa[0], pb[0])]
    out = None
    for x, y in pairs:
        p = pair_fn(x, y)
        out = p if out is None else out + p
    return out


def _bmm_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return torch.bmm(x, y, out_dtype=torch.float32)
    return torch.bmm(x, y)


def _bmm_passes(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """One batched GEMM for all the passes: with three, the summed axis
    holds the part pairs side by side, (hi_a | lo_a | hi_a) against
    (lo_b ; hi_b ; hi_b), so the passes accumulate in float32 inside the
    GEMM, small terms first, as they do in the TPU's matrix unit."""
    pa, pb = _parts(a, passes), _parts(b, passes)
    if passes == 1:
        return _bmm_pair(pa[0], pb[0])
    return _bmm_pair(torch.cat([pa[0], pa[1], pa[0]], dim=-1), torch.cat([pb[1], pb[0], pb[0]], dim=-2))


def _outer_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * y.to(torch.float32)


def bmm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """(Bt, m, k) @ (Bt, k, n) under ``passes``.  With k = 1 nothing is
    summed over k: each pass's term is one product of two bf16 values,
    exact in float32, so the parts are multiplied elementwise and the
    passes added in float32 (cuBLAS's bf16 rank-1 kernel took a third of
    the filter's device time at B=256)."""
    check_passes(passes)
    if not _applies(passes, a, b):
        return torch.bmm(a, b)
    with _direct():
        if a.shape[-1] == 1:
            return _sum_passes(_outer_pair, a, b, passes)
        return _bmm_passes(a, b, passes)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``torch.matmul`` (1-D operands, broadcast batch axes) under
    ``passes``."""
    check_passes(passes)
    if not _applies(passes, a, b):
        return torch.matmul(a, b)
    with _direct():
        va, vb = a.dim() == 1, b.dim() == 1
        a = a[None] if va else a
        b = b[:, None] if vb else b
        (m, k), n = a.shape[-2:], b.shape[-1]
        if b.dim() == 2:  # one right operand: fold a's batch axes into its rows
            out = bmm(a.reshape(1, -1, k), b[None], passes).reshape(a.shape[:-1] + (n,))
        else:
            batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
            A = a.expand(batch + (m, k)).reshape(-1, m, k)
            B = b.expand(batch + (k, n)).reshape(-1, k, n)
            out = bmm(A, B, passes).reshape(batch + (m, n))
        if va:
            out = out.squeeze(-2)
        if vb:
            out = out.squeeze(-1)
        return out


def _expand_ellipsis(specs, out, operands):
    """Letter-only specs of an einsum equation: '...' becomes the same free
    letters, right-aligned, in every operand and in the output."""
    used = set("".join(specs) + (out or ""))
    free = [c for c in string.ascii_letters if c not in used]
    ndims = [op.dim() - (len(s) - 3) if "..." in s else 0 for s, op in zip(specs, operands)]
    E = max(ndims, default=0)
    ell = "".join(free[:E])
    specs = [s.replace("...", ell[E - e:]) for s, e in zip(specs, ndims)]
    if out is None:
        once = sorted(c for c in set("".join(specs)) if "".join(specs).count(c) == 1 and c not in ell)
        out = ell + "".join(once)
    else:
        out = out.replace("...", ell)
    return specs, out


def _contract(sa: str, a: torch.Tensor, sb: str, b: torch.Tensor, keep: str, passes: int):
    """The product of two einsum operands as one batched GEMM: letters in
    both and in ``keep`` are batch axes, letters in both and not in
    ``keep`` are summed, the rest are rows of a or columns of b.  Returns
    (letters, tensor)."""
    for s in (sa, sb):
        if len(set(s)) != len(s):
            raise ValueError(f"einsum operand {s!r} repeats a letter")
    # Letters only one operand has and no one needs are summed first.
    def presum(s, x, other):
        drop = [i for i, c in enumerate(s) if c not in keep and c not in other]
        if not drop:
            return s, x
        return "".join(c for i, c in enumerate(s) if i not in drop), x.sum(dim=drop)

    (sa, a), (sb, b) = presum(sa, a, sb), presum(sb, b, sa)
    size = {c: n for s, x in ((sa, a), (sb, b)) for c, n in zip(s, x.shape) if n != 1}
    a = a.expand([size.get(c, 1) for c in sa])
    b = b.expand([size.get(c, 1) for c in sb])
    batch = [c for c in sa if c in sb and c in keep]
    summed = [c for c in sa if c in sb and c not in keep]
    rows = [c for c in sa if c not in sb]
    cols = [c for c in sb if c not in sa]

    def numel(cs):
        n = 1
        for c in cs:
            n *= size.get(c, 1)
        return n

    A = a.permute([sa.index(c) for c in batch + rows + summed]).reshape(numel(batch), numel(rows), numel(summed))
    B = b.permute([sb.index(c) for c in batch + summed + cols]).reshape(numel(batch), numel(summed), numel(cols))
    out = bmm(A, B, passes).reshape([size.get(c, 1) for c in batch + rows + cols])
    return "".join(batch + rows + cols), out


def einsum(equation: str, *operands, passes: int) -> torch.Tensor:
    """``torch.einsum`` under ``passes``: the operands contracted pairwise
    from the left, each pair one batched GEMM under the passes."""
    check_passes(passes)
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if not _applies(passes, *operands):
        return torch.einsum(equation, *operands)
    with _direct():
        eq = equation.replace(" ", "")
        lhs, out = eq.split("->") if "->" in eq else (eq, None)
        specs, out = _expand_ellipsis(lhs.split(","), out, operands)
        if len(operands) == 1:
            return torch.einsum(f"{specs[0]}->{out}", operands[0])
        s, x = specs[0], operands[0]
        for i in range(1, len(operands)):
            keep = set(out).union(*specs[i + 1:])
            s, x = _contract(s, x, specs[i], operands[i], "".join(sorted(keep)), passes)
        return torch.einsum(f"{s}->{out}", x) if s != out else x


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1, *, passes: int) -> torch.Tensor:
    """``F.conv2d`` under ``passes``.  On the CPU a float32 convolution of
    each part pair; on the card ``unfold`` and one batched GEMM per pair
    (group by group, the columns of every image)."""
    check_passes(passes)
    if not _applies(passes, x, w):
        return F.conv2d(x, w, bias, stride, padding, dilation, groups)
    with _direct():
        if x.device.type == "cpu":
            out = _sum_passes(lambda p, q: F.conv2d(p, q, None, stride, padding, dilation, groups), x, w, passes)
        else:
            if isinstance(padding, str):
                if padding != "valid":
                    raise ValueError(f"conv2d padding {padding!r}: only 'valid' or sizes under bf16 passes")
                padding = 0
            Nb, Cin, H, W = x.shape
            Cout, Cg, kh, kw = w.shape
            pair = torch.nn.modules.utils._pair
            (sh, sw), (ph, pw), (dh, dw) = pair(stride), pair(padding), pair(dilation)
            Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            cols = F.unfold(x, (kh, kw), dilation, padding, stride)  # (Nb, Cin*kh*kw, Ho*Wo)
            cols = cols.reshape(Nb * groups, Cg * kh * kw, Ho * Wo)
            wg = w.reshape(1, groups, Cout // groups, Cg * kh * kw).expand(Nb, -1, -1, -1)
            out = bmm(wg.reshape(Nb * groups, Cout // groups, Cg * kh * kw), cols, passes)
            out = out.reshape(Nb, Cout, Ho, Wo)
        return out if bias is None else out + bias.reshape(1, -1, 1, 1)


_HANDLERS = {
    **{f: (lambda a, b: matmul(a, b, _passes)) for f in (
        torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.Tensor.mm,
        torch.mv, torch.Tensor.mv, torch.dot, torch.Tensor.dot)},
    torch.bmm: lambda a, b: bmm(a, b, _passes),
    torch.Tensor.bmm: lambda a, b: bmm(a, b, _passes),
    torch.einsum: lambda eq, *ops: einsum(eq, *ops, passes=_passes),
    torch.conv2d: lambda *a, **kw: conv2d(*a, **kw, passes=_passes),
}


class _Bf16Products(TorchFunctionMode):
    """Routes the product functions of ``_HANDLERS`` through the helpers
    while the pass count is not 0; every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = _HANDLERS.get(func)
        if handler is None or _passes == 0 or (kwargs and func is not torch.conv2d):
            return func(*args, **kwargs)
        return handler(*args, **kwargs)


@contextlib.contextmanager
def products(passes: int):
    """Run the block with ``passes`` bf16 passes (0 = float32) for every
    float32 product; the previous count comes back on exit."""
    global _passes, _mode
    check_passes(passes)
    installed = None
    if passes and _mode is None:
        installed = _mode = _Bf16Products()
        installed.__enter__()
    prev, _passes = _passes, passes
    try:
        yield
    finally:
        _passes = prev
        if installed is not None:
            _mode = None
            installed.__exit__(None, None, None)
