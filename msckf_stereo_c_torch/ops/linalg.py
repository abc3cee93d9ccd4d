"""Closed-form small solves, the Newton-Schulz SPD inverse (port of
``msckf_stereo_c_tpu/ops/linalg.py``) and the factorizations of the
filter's exact paths, batched over leading dims.

The factorizations follow ``jnp.linalg``: a matrix that does not factor
gives NaN where torch would raise.  They never check an error code, so on
the card they queue without a host read; a NaN gating score then fails its
chi-square test, as in the JAX package."""
from __future__ import annotations

import torch


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
