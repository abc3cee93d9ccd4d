"""SE(3) pose-graph optimization and its sharded form over
``torch.distributed`` (port of ``msckf_stereo_c_tpu/parallel/posegraph.py``).

Keyframe poses of one or more VIO sessions are refined against
relative-pose constraints (odometry edges from the filter, loop-closure and
inter-session edges) by Gauss-Newton on the 6-dof pose manifold.  Each rank
holds a block of edges and the replicated poses; its normal equations are
summed over the ranks by an ``all_reduce``, as the BA layer (``ba.py``)
does with landmarks.

Residual for edge (i, j) with measured relative transform (R_ij, t_ij)
(maps frame-j vectors to frame i under the world->frame convention of the
filter):  r_rot = log(R_ij^T R_i R_j^T),  r_trans = R_i (p_j - p_i) - t_ij.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import cho_solve, cholesky_nan
from ..utils.lie import skew, so3_log
from ..utils.quaternion import jpl_to_rot, quat_multiply, small_angle_quaternion
from .collectives import all_reduce_sum, block, resolve_group


class PoseGraph(NamedTuple):
    q: torch.Tensor  # (F, 4) JPL world->frame
    p: torch.Tensor  # (F, 3) frame position in world
    edge_i: torch.Tensor  # (E,) integer node indices
    edge_j: torch.Tensor  # (E,)
    R_meas: torch.Tensor  # (E, 3, 3) measured R_ij (frame j -> frame i vectors)
    t_meas: torch.Tensor  # (E, 3) measured R_i (p_j - p_i)
    weight: torch.Tensor  # (E,) information weight (0 disables an edge)


def _edge_residual(q_i, p_i, q_j, p_j, R_m, t_m):
    """(..., 6) residuals [r_rot, r_trans], batched over leading dims."""
    return _edge_residual_jac(q_i, p_i, q_j, p_j, R_m, t_m)[0]


def _right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """J_r(phi)^-1 = I + K/2 + (1/t^2 - (1 + cos t) / (2 t sin t)) K^2, K =
    [phi]x, t = |phi| (series 1/12 + t^2/720 below t^2 = 1e-6): the
    derivative of log(exp(phi) exp(eps)) in eps at 0."""
    K = skew(phi)
    tsq = torch.sum(phi * phi, dim=-1)
    small = tsq < 1e-6
    t = torch.sqrt(torch.where(small, torch.ones_like(tsq), tsq))
    coef = torch.where(small, 1.0 / 12.0 + tsq / 720.0,
                       1.0 / (t * t) - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + coef[..., None, None] * (K @ K)


def _edge_residual_jac(q_i, p_i, q_j, p_j, R_m, t_m):
    """Residuals (..., 6) and their Jacobians (..., 6, 6) w.r.t. [dtheta_i,
    dp_i] and [dtheta_j, dp_j] (left-multiplicative JPL error, the filter's
    convention: C(dq (x) q) = (I - [dtheta]x) C(q) to first order), in
    closed form.  With N = R_i R_j^T and phi = log(R_m^T N):
    d r_rot = J_r(phi)^-1 (dtheta_j - N^T dtheta_i), d r_t = [R_i (p_j -
    p_i)]x dtheta_i + R_i (dp_j - dp_i)."""
    R_i = jpl_to_rot(q_i)
    N = R_i @ jpl_to_rot(q_j).transpose(-1, -2)
    phi = so3_log(R_m.transpose(-1, -2) @ N)
    Ri_d = (R_i @ (p_j - p_i)[..., None])[..., 0]
    r = torch.cat([phi, Ri_d - t_m], dim=-1)
    Jinv = _right_jacobian_inv(phi)
    zero = torch.zeros_like(R_i)
    J_i = torch.cat([torch.cat([-Jinv @ N.transpose(-1, -2), zero], -1),
                     torch.cat([skew(Ri_d), -R_i], -1)], -2)
    J_j = torch.cat([torch.cat([Jinv, zero], -1), torch.cat([zero, R_i], -1)], -2)
    return r, J_i, J_j


def _assemble(graph: PoseGraph, F: int):
    """Normal equations H (F, F, 6, 6), b (F, 6) and the cost over this
    rank's edges.  Every interior node is both an ``edge_i`` and an
    ``edge_j``, so the scatters accumulate (``index_put_(...,
    accumulate=True)``, ``index_add_``) with int64 indices."""
    dtype = graph.p.dtype
    ei = graph.edge_i.long()
    ej = graph.edge_j.long()
    r, Ji, Jj = _edge_residual_jac(graph.q[ei], graph.p[ei], graph.q[ej], graph.p[ej],
                                   graph.R_meas, graph.t_meas)
    # ``weight`` is the edge information (1/sigma^2): it scales H and b by
    # the same power.
    w = graph.weight[:, None, None]
    Hii = torch.einsum("eab,eac->ebc", Ji * w, Ji)
    Hjj = torch.einsum("eab,eac->ebc", Jj * w, Jj)
    Hij = torch.einsum("eab,eac->ebc", Ji * w, Jj)
    bi = torch.einsum("eab,ea->eb", Ji * w, r)
    bj = torch.einsum("eab,ea->eb", Jj * w, r)

    H = torch.zeros((F, F, 6, 6), dtype=dtype, device=r.device)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((F, 6), dtype=dtype, device=r.device)
    b.index_add_(0, ei, bi)
    b.index_add_(0, ej, bj)
    cost = torch.sum(graph.weight * torch.sum(r * r, dim=-1))
    return H, b, cost


def _solve_and_update(q, p, H, b, damping, gauge_fix: int = 1):
    """One Gauss-Newton step with the first ``gauge_fix`` poses clamped; a
    system that does not factor gives NaN, with no host read."""
    F = q.shape[0]
    n = 6 * F
    Hm = H.permute(0, 2, 1, 3).reshape(n, n)
    Hm = Hm + damping * torch.eye(n, dtype=Hm.dtype, device=Hm.device)
    gmask = (torch.arange(n, device=Hm.device) < 6 * gauge_fix).to(Hm.dtype)
    Hm = Hm + torch.diag(gmask * 1e12)
    delta = -cho_solve(cholesky_nan(Hm), b.reshape(n, 1)).reshape(F, 6)
    return quat_multiply(small_angle_quaternion(delta[:, :3]), q), p + delta[:, 3:6]


def _iterate(graph: PoseGraph, iters: int, damping: float, group):
    """``iters`` Gauss-Newton steps over this rank's edges, the normal
    equations summed over ``group`` (None: the edges are the whole graph).
    The costs stay on the device."""
    F = graph.q.shape[0]
    q, p = graph.q, graph.p
    costs = []
    for _ in range(iters):
        H, b, cost = _assemble(graph._replace(q=q, p=p), F)
        H, b, cost = all_reduce_sum((H, b, cost), group)
        q, p = _solve_and_update(q, p, H, b, damping)
        costs.append(cost)
    return graph._replace(q=q, p=p), torch.stack(costs)


def optimize_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-8):
    """One-process Gauss-Newton (the oracle for the sharded runner).
    Returns the refined graph and the cost before each step (iters,)."""
    return _iterate(graph, iters, damping, None)


def shard_pose_graph(graph: PoseGraph, world: int, rank: int) -> PoseGraph:
    """``rank``'s block of edges (``collectives.block``) with the replicated
    poses; the last blocks are padded with zero-weight edges (node 0 to
    itself, identity measurement), which add nothing."""
    E = graph.edge_i.shape[0]
    s, e, size = block(E, world, rank)
    pad = size - (min(e, E) - min(s, E))
    R = graph.R_meas

    def rows(x, fill):
        x = x[min(s, E):min(e, E)]
        return torch.cat([x, fill.to(x.dtype).expand(pad, *x.shape[1:])]) if pad else x

    return graph._replace(
        edge_i=rows(graph.edge_i, torch.zeros((), device=R.device)),
        edge_j=rows(graph.edge_j, torch.zeros((), device=R.device)),
        R_meas=rows(R, torch.eye(3, device=R.device)),
        t_meas=rows(graph.t_meas, torch.zeros(3, device=R.device)),
        weight=rows(graph.weight, torch.zeros((), device=R.device)),
    )


def make_distributed_pose_graph(group=None, iters: int = 10, damping: float = 1e-8):
    """The sharded pose-graph runner: ``run(block)`` takes this rank's edge
    block (``shard_pose_graph``) and the replicated poses, sums the normal
    equations over ``group``'s ranks each iteration, and returns the
    refined graph (poses replicated) and the summed costs.  ``group=None``
    is the default group, or the one-process solve when no process group is
    initialised."""
    group, _, _ = resolve_group(group)

    def run(graph: PoseGraph):
        return _iterate(graph, iters, damping, group)

    return run


def odometry_edges(q: np.ndarray, p: np.ndarray, stride: int = 1, weight: float = 1.0):
    """Consecutive relative-pose edges measured from a trajectory (the VIO
    output), as numpy arrays (ei, ej, R_m, t_m, w)."""
    F = q.shape[0]
    ei = np.arange(0, F - stride, stride, dtype=np.int32)
    ej = ei + stride
    R = jpl_to_rot(torch.as_tensor(np.array(q, np.float64))).numpy()
    R_m = np.einsum("eij,ekj->eik", R[ei], R[ej])  # R_i R_j^T
    t_m = np.einsum("eij,ej->ei", R[ei], p[ej] - p[ei])
    w = np.full(len(ei), weight)
    return ei, ej, R_m, t_m, w
