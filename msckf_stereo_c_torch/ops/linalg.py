"""Closed-form small solves, the Newton-Schulz SPD inverse (port of
``msckf_stereo_c_tpu/ops/linalg.py``) and the factorizations of the
filter's exact paths, batched over leading dims.

The factorizations follow ``jnp.linalg``: a matrix that does not factor
gives NaN where torch would raise.  They never check an error code, so on
the card they queue without a host read; a NaN gating score then fails its
chi-square test, as in the JAX package.

``qr_r`` (the R factor of a thin QR of every lane's matrix) launches the
hand-written kernel ``qr_compress`` (``csrc/qr_compress.cu``) on a CUDA
tensor and runs its plain version, ``qr_r_reference``
(``torch.linalg.qr``), on a CPU one."""
from __future__ import annotations

import collections
import math

import torch

from ..utils.timing import profiling
from . import _cuda

# The work of each ``qr_r`` call made while a profiler records, newest
# last: (W, element size in bytes), W a (..., 2) int32 tensor on the
# call's device holding each matrix's rows and columns that have a nonzero
# (or NaN) entry, the block whose QR is its least work.  The kernel counts
# them in its pass; on the CPU two reductions do.  Nothing is kept while no
# profiler records.
qr_work_log: collections.deque = collections.deque(maxlen=256)


def _safe_inv(det: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))


def _cofactors3(A: torch.Tensor):
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c = (
        (a11 * a22 - a12 * a21, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11),
        (a12 * a20 - a10 * a22, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12),
        (a10 * a21 - a11 * a20, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10),
    )
    det = a00 * c[0][0] + a01 * c[0][1] + a02 * c[0][2]
    return c, det


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adjugate solve of A x = b for 3x3 A."""
    c, det = _cofactors3(A)
    inv_det = _safe_inv(det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [(c[i][0] * b0 + c[i][1] * b1 + c[i][2] * b2) * inv_det for i in range(3)],
        dim=-1,
    )


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of 3x3 matrices."""
    c, det = _cofactors3(A)
    inv_det = _safe_inv(det)[..., None, None]
    adj = torch.stack([torch.stack(list(row), dim=-1) for row in c], dim=-2)
    return adj * inv_det


def ns_posdef_inverse(M: torch.Tensor, min_eig, iters: int = 14) -> torch.Tensor:
    """Inverse of a matrix with real spectrum >= ``min_eig`` > 0 by scaled
    Newton-Schulz iteration: ``2*iters`` batched matmuls, no factorization.
    See the JAX original for the scaling argument."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    min_eig = torch.as_tensor(min_eig, dtype=M.dtype, device=M.device)
    c = torch.amax(torch.sum(torch.abs(M), dim=-1), dim=-1)
    c = torch.maximum(c, min_eig)
    m = min_eig / c
    X = eye * (1.0 / c)[..., None, None]
    for _ in range(iters):
        s = 2.0 / (1.0 + m)
        X = X * s[..., None, None]
        T = M @ X
        X = 2.0 * X - X @ T
        sm = s * m
        m = sm * (2.0 - sm)
    return X


def solve2x2(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form solve for 2x2 systems (batched)."""
    a, bb = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    inv_det = _safe_inv(a * d - bb * c)
    x0 = (d * b[..., 0] - bb * b[..., 1]) * inv_det
    x1 = (-c * b[..., 0] + a * b[..., 1]) * inv_det
    return torch.stack([x0, x1], dim=-1)


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``A`` (..., n, n); NaN where
    the matrix is not positive definite (``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b for lower-triangular ``L`` (..., n, n) and ``b`` (..., n)."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B from the lower factor ``L`` of A (..., n, n), B (..., n, k)
    (``jax.scipy.linalg.cho_solve``)."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve_nan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B by LU (``jnp.linalg.solve``) for A (..., n, n), B (..., n, k);
    NaN where A is singular."""
    X, info = torch.linalg.solve_ex(A, B, check_errors=False)
    return torch.where((info == 0)[..., None, None], X, float("nan"))


def qr_r_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain version of ``qr_compress``: the R factor of a reduced QR of
    each (m, n) matrix of ``A`` (..., m, n), (..., min(m, n), n)."""
    return torch.linalg.qr(A, mode="r").R


def qr_r(A: torch.Tensor) -> torch.Tensor:
    """(..., n, n) upper-triangular R with R^T R = A^T A for each (m, n)
    matrix of ``A`` (..., m, n), float32 or float64: on a CUDA tensor one
    launch of ``qr_compress`` over every matrix, on a CPU tensor
    ``qr_r_reference`` (whose R has min(m, n) rows; the same (n, n) where
    m >= n).  R is one of the factors that differ by the signs of their rows
    (and, where A is rank deficient, by more); every one gives the same
    R^T R, and a matrix of zeros gives R = 0.  A matrix holding a NaN gives
    a non-finite R, as the plain version does.  While a profiler records,
    each call's nonzero rows and columns go to ``qr_work_log``."""
    record = profiling()
    if A.device.type == "cpu":
        if record:
            nz = A != 0
            W = torch.stack([nz.any(-1).sum(-1), nz.any(-2).sum(-1)], -1).to(torch.int32)
            qr_work_log.append((W, A.element_size()))
        return qr_r_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qr_r takes float32 or float64, got {A.dtype}")
    lead, (m, n) = A.shape[:-2], A.shape[-2:]
    # One thread a column, and the packed R, two reflectors of ``chunk``
    # rows and two 8-byte row masks in one block's shared memory (227 KB).
    chunk = 32 if A.dtype == torch.float64 else 64
    if n > 1024 or (n * (n + 1) // 2 + 2 * chunk + 2) * A.element_size() + 16 > 232448:
        raise ValueError(f"qr_compress takes at most the columns one block holds; got n={n} in {A.dtype}")
    B = math.prod(lead)
    R = torch.empty(lead + (n, n), dtype=A.dtype, device=A.device)
    W = None
    if record:
        W = torch.empty(lead + (2,), dtype=torch.int32, device=A.device)
        qr_work_log.append((W, A.element_size()))
    if B == 0 or n == 0:  # the kernel launches nothing for it, so nothing is counted
        if W is not None:
            W.zero_()
        return R
    if B > 2**31 - 1 or m > 2**31 - 1:
        raise ValueError(f"qr_compress takes at most 2^31 - 1 matrices and rows, got {B} and {m}")
    A = A.contiguous()
    _cuda.launch("qr_compress", A.data_ptr(), R.data_ptr(), None if W is None else W.data_ptr(), B, m, n,
                 int(A.dtype == torch.float64), torch.cuda.current_stream(A.device).cuda_stream)
    return R
