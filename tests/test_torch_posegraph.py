"""The port's SE(3) pose graph (``msckf_stereo_c_torch/parallel/posegraph.py``)
against the JAX package's, in float64 on the CPU, on tests/test_posegraph.py's
graph (a drifted 16-pose helix with perfect odometry edges and one loop
closure; built here with its own generator so that its draws are
untouched).

Tolerances: ``_edge_residual_jac`` (closed form against jax.jacfwd under
vmap) within 1e-10 relative to each output's largest entry, a zero-angle
edge included, where ``so3_log``'s series branch is taken; ``_assemble`` within 1e-10 relative; ``optimize_pose_graph`` costs
rtol 1e-9 (atol 1e-20 on the numerical zeros), poses within 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.convert import from_numpy
from msckf_stereo_c_torch.parallel import posegraph as tpg
from msckf_stereo_c_tpu.parallel import posegraph as jpg
from msckf_stereo_c_tpu.utils.lie import so3_exp
from msckf_stereo_c_tpu.utils.quaternion import jpl_to_rot, rot_to_jpl


def make_graph(rng, F=16, drift=0.03):
    """tests/test_posegraph.py:_graph's construction with the draws of
    ``rng``: (JAX PoseGraph, true q, true p)."""
    qs, ps = [], []
    for i in range(F):
        a = 2 * np.pi * i / F
        c, s = np.cos(a), np.sin(a)
        qs.append(np.asarray(rot_to_jpl(jnp.asarray(np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])))))
        ps.append([2 * np.cos(a), 2 * np.sin(a), 0.1 * i])
    q_true, p_true = np.asarray(qs), np.asarray(ps)
    ei, ej, Rm, tm, w = jpg.odometry_edges(q_true, p_true)
    R = np.asarray(jpl_to_rot(jnp.asarray(q_true)))
    ei = np.concatenate([ei, [F - 1]]).astype(np.int32)
    ej = np.concatenate([ej, [0]]).astype(np.int32)
    Rm = np.concatenate([Rm, (R[F - 1] @ R[0].T)[None]])
    tm = np.concatenate([tm, (R[F - 1] @ (p_true[0] - p_true[F - 1]))[None]])
    w = np.concatenate([w, [1.0]])
    qd, pd = [q_true[0]], [p_true[0]]
    for i in range(1, F):
        dth = rng.normal(0, drift, 3) * i / F
        qd.append(np.asarray(rot_to_jpl(so3_exp(jnp.asarray(dth)) @ jpl_to_rot(jnp.asarray(q_true[i])))))
        pd.append(p_true[i] + rng.normal(0, drift, 3) * i / F)
    graph = jpg.PoseGraph(q=jnp.asarray(qd), p=jnp.asarray(pd), edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
                          R_meas=jnp.asarray(Rm), t_meas=jnp.asarray(tm), weight=jnp.asarray(w))
    return graph, q_true, p_true


def to_port(graph) -> tpg.PoseGraph:
    return from_numpy(jax.device_get(graph), device="cpu")


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def graphs():
    """tests/test_posegraph.py's graphs (F = 16 and 17), drawn in its order
    from its seed, with mixed weights on a copy of the second."""
    rng = np.random.default_rng(23)
    g16, q_true, p_true = make_graph(rng)
    g17 = make_graph(rng, F=17)[0]
    w = np.where(np.arange(17) % 3 == 0, 1e4, 2.5)
    return {"F16": g16, "F17": g17, "F17_weighted": g17._replace(weight=jnp.asarray(w)),
            "truth": (q_true, p_true)}


def _edge_args(graph):
    ei, ej = np.asarray(graph.edge_i), np.asarray(graph.edge_j)
    return (graph.q[ei], graph.p[ei], graph.q[ej], graph.p[ej], graph.R_meas, graph.t_meas)


def test_edge_residual_jac_matches_jax(graphs):
    """Every edge of the drifted graph, and one edge whose measurement is
    its poses' own relative pose (zero residual angle: so3_log's series
    branch)."""
    g = graphs["F16"]
    q, p = np.array(g.q), np.array(g.p)
    R = np.array(jpl_to_rot(g.q))
    zero = (q[3:4], p[3:4], q[4:5], p[4:5], (R[3] @ R[4].T)[None], (R[3] @ (p[4] - p[3]))[None])
    for args in (tuple(np.array(a) for a in _edge_args(g)), zero):
        want = jpg._edge_rj(*(jnp.asarray(a) for a in args))
        got = tpg._edge_residual_jac(*(torch.as_tensor(a) for a in args))
        for gg, w in zip(got, want):
            assert gg.shape == w.shape and gg.dtype == torch.float64
        # The zero edge's residual is rounding noise (about 1e-16 m): held
        # absolutely there.
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                                   atol=1e-10 * float(np.max(np.abs(want[0]))) if args is not zero else 1e-15)
        assert rel_err(got[1], want[1]) < 1e-10 and rel_err(got[2], want[2]) < 1e-10
    assert float(torch.abs(got[0][0, :3]).max()) < 1e-15  # zero angle: the series branch
    assert float(torch.abs(got[1]).max()) > 0.5


@pytest.mark.parametrize("name", ["F16", "F17_weighted"])
def test_assemble_matches_jax(graphs, name):
    """H, b and the cost: every interior node is both an edge_i and an
    edge_j, so the scatters must accumulate."""
    g = graphs[name]
    F = g.q.shape[0]
    want = jpg._assemble(g, F)
    got = tpg._assemble(to_port(g), F)
    for gg, w in zip(got, want):
        assert rel_err(gg, w) < 1e-10
    # H's diagonal blocks hold two edges' terms at an interior node.
    Hii = got[0][5, 5]
    one = tpg._assemble(to_port(g)._replace(edge_i=torch.tensor([4]), edge_j=torch.tensor([5]),
                                            R_meas=to_port(g).R_meas[4:5], t_meas=to_port(g).t_meas[4:5],
                                            weight=to_port(g).weight[4:5]), F)[0][5, 5]
    assert float(torch.abs(Hii - one).max()) > 1e-3


@pytest.mark.parametrize("name,iters", [("F16", 15), ("F17", 8), ("F17_weighted", 10)])
def test_optimize_pose_graph_matches_jax(graphs, name, iters):
    g = graphs[name]
    want, wc = jpg.optimize_pose_graph(g, iters=iters)
    got, gc = tpg.optimize_pose_graph(to_port(g), iters=iters)
    assert gc.shape == (iters,)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-9)
    if name == "F16":
        assert float(gc[-1]) < 1e-16
        np.testing.assert_allclose(got.p.numpy(), graphs["truth"][1], atol=1e-6)


def test_odometry_edges_match_jax(graphs):
    g = graphs["F16"]
    q, p = np.asarray(g.q), np.asarray(g.p)
    for stride, weight in ((1, 1.0), (3, 1e4)):
        want = jpg.odometry_edges(q, p, stride=stride, weight=weight)
        got = tpg.odometry_edges(q, p, stride=stride, weight=weight)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype == np.int32
        for gg, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(gg, w, rtol=0, atol=1e-14)


def test_shards_pad_with_zero_weight_edges(graphs):
    """shard_pose_graph's blocks cover the edges in order, pad with
    zero-weight identity edges, and the padded normal equations equal the
    unpadded ones; one process's make_distributed_pose_graph equals
    optimize_pose_graph."""
    tg = to_port(graphs["F17"])
    E = tg.edge_i.shape[0]
    blocks = [tpg.shard_pose_graph(tg, 4, r) for r in range(4)]
    assert [b.edge_i.shape[0] for b in blocks] == [5, 5, 5, 5] and E == 17
    assert torch.equal(torch.cat([b.edge_j for b in blocks])[:E], tg.edge_j)
    assert torch.equal(blocks[3].weight[2:], torch.zeros(3, dtype=torch.float64))
    assert torch.equal(blocks[3].R_meas[-1], torch.eye(3, dtype=torch.float64))
    H, b, c = (sum(x) for x in zip(*(tpg._assemble(blk, 17) for blk in blocks)))
    Hw, bw, cw = tpg._assemble(tg, 17)
    for x, y in ((H, Hw), (b, bw), (c, cw)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=1e-12)
    got, gc = tpg.make_distributed_pose_graph(None, iters=4)(tg)
    want, wc = tpg.optimize_pose_graph(tg, iters=4)
    assert torch.equal(gc, wc) and torch.equal(got.p, want.p)
