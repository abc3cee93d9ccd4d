"""The port's batch BA (``msckf_stereo_c_torch/parallel/ba.py``) against the
JAX package's, in float64 on the CPU, on tests/test_ba.py's problem
(cameras on an arc over a landmark cloud; built here with its own
generator so that tests/test_ba.py's draws are untouched).

Tolerances: ``_residual_jacobians`` and ``_local_blocks`` within 1e-10
relative to each output's largest entry; ``ba_gauss_newton`` costs rtol
1e-9 (atol 1e-20 on the numerical zeros of the converged steps), poses and
landmarks within 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.convert import from_numpy, to_numpy
from msckf_stereo_c_torch.parallel import ba as tba
from msckf_stereo_c_tpu.parallel import ba as jba
from msckf_stereo_c_tpu.utils.lie import so3_exp
from msckf_stereo_c_tpu.utils.quaternion import jpl_to_rot, rot_to_jpl

R01 = np.eye(3)
T01 = np.array([-0.1, 0.0, 0.0])


def make_problem(rng, F=6, L=64, noise=0.0, perturb=0.02):
    """tests/test_ba.py:_make_problem's construction with the draws of
    ``rng``: (true, perturbed) as the JAX package's BAProblem of float64
    arrays."""
    qs, ps = [], []
    for i in range(F):
        a = 0.25 * i
        c, s = np.cos(0.08 * i), np.sin(0.08 * i)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        qs.append(np.asarray(rot_to_jpl(jnp.asarray(R))))
        ps.append([2.0 * np.sin(a), 0.05 * i, -2.0 * np.cos(a)])
    cam_q, cam_p = jnp.asarray(qs), jnp.asarray(ps)
    lms = jnp.asarray(rng.uniform(-1.0, 1.0, (L, 3)) + np.array([0, 0, 1.5]))
    R0 = jpl_to_rot(cam_q)
    p_c0 = jnp.einsum("fij,lfj->lfi", R0, lms[:, None] - cam_p[None])
    p_c1 = jnp.einsum("ij,lfj->lfi", R01, p_c0) + T01
    mask = (p_c0[..., 2] > 0.3) & (p_c1[..., 2] > 0.3)
    obs = jnp.concatenate([p_c0[..., :2] / p_c0[..., 2:], p_c1[..., :2] / p_c1[..., 2:]], axis=-1)
    obs = (obs + noise * jnp.asarray(rng.standard_normal(obs.shape))) * mask[..., None]
    true = jba.BAProblem(cam_q, cam_p, lms, obs, mask, jnp.asarray(R01), jnp.asarray(T01))
    dth = rng.normal(0, perturb, (F, 3))
    dp = rng.normal(0, perturb, (F, 3))
    dth[0] = dp[0] = 0
    q_pert = jax.vmap(lambda q, d: rot_to_jpl(so3_exp(d) @ jpl_to_rot(q)))(cam_q, jnp.asarray(dth))
    pert = true._replace(cam_q=q_pert, cam_p=cam_p + jnp.asarray(dp),
                         landmarks=lms + jnp.asarray(rng.normal(0, perturb, (L, 3))))
    return true, pert


def to_port(prob) -> tba.BAProblem:
    return from_numpy(jax.device_get(prob), device="cpu")


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def problems():
    """tests/test_ba.py's two problems, drawn in its order from its seed."""
    rng = np.random.default_rng(17)
    clean = make_problem(rng)[1]
    return {"clean": clean, "noisy": make_problem(rng, noise=1e-3, perturb=0.05)[1]}


def test_residual_jacobians_match_jax(problems):
    """Every (landmark, keyframe) pair's residual and both Jacobians, the
    port's one broadcast computation against JAX's vmap of vmap."""
    jp = problems["noisy"]
    tp = to_port(jp)
    want = jba._rj_grid(jp.cam_q, jp.cam_p, jp.landmarks, jp.obs, jp.R_c0_c1, jp.t_c0_c1)
    got = tba._residual_jacobians(tp.cam_q[None], tp.cam_p[None], tp.landmarks[:, None], tp.obs,
                                  tp.R_c0_c1, tp.t_c0_c1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        assert rel_err(g, w) < 1e-10


@pytest.mark.parametrize("name", ["clean", "noisy"])
def test_local_blocks_match_jax(problems, name):
    """Hpp (with the diagonal added by index_put_ accumulate), bp, Hll^-1,
    W, bl and the cost."""
    jp = problems[name]
    want = jba._local_blocks(jp, 1e-6)
    got = tba._local_blocks(to_port(jp), 1e-6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert rel_err(g, w) < 1e-10


@pytest.mark.parametrize("name,iters", [("clean", 15), ("noisy", 15), ("clean", 3)])
def test_ba_gauss_newton_matches_jax(problems, name, iters):
    jp = problems[name]
    want, wc = jba.ba_gauss_newton(jp, iters=iters)
    got, gc = tba.ba_gauss_newton(to_port(jp), iters=iters)
    assert gc.shape == (iters,)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-9, atol=1e-20)
    for field in ("cam_q", "cam_p", "landmarks"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=0, atol=1e-9)
    if name == "clean" and iters == 15:
        assert float(gc[-1]) < 1e-12


def test_pose_solve_failure_gives_nan():
    """A pose system that does not factor gives NaN steps, not an
    exception (the factor is cholesky_nan's, no host read)."""
    Hpp = torch.zeros((2, 2, 6, 6), dtype=torch.float64)
    Hpp[1, 1] = -torch.eye(6, dtype=torch.float64)
    step = tba._solve_poses(Hpp, torch.ones((2, 6), dtype=torch.float64), 1e-6)
    assert torch.isnan(step).all()


def test_shards_cover_the_problem(problems):
    """shard_ba_problem's blocks: contiguous, padded with unobserved
    landmarks, and one process's make_distributed_ba (no process group)
    equal to ba_gauss_newton."""
    tp = tba.BAProblem(*(x[:61] if x.ndim and x.shape[0] == 64 else x for x in to_port(problems["clean"])))
    blocks = [tba.shard_ba_problem(tp, 3, r) for r in range(3)]
    assert [b.landmarks.shape[0] for b in blocks] == [21, 21, 21]
    assert torch.equal(torch.cat([b.landmarks for b in blocks])[:61], tp.landmarks)
    assert torch.equal(torch.cat([b.obs for b in blocks])[:61], tp.obs)
    assert not blocks[2].mask[-2:].any() and torch.equal(torch.cat([b.mask for b in blocks])[:61], tp.mask)
    assert torch.equal(blocks[0].cam_q, tp.cam_q)
    # A padded block's landmarks contribute nothing to the pose system.
    H1, b1, *_, c1 = tba._local_blocks(blocks[2], 1e-6)
    H2, b2, *_, c2 = tba._local_blocks(blocks[2]._replace(
        landmarks=blocks[2].landmarks[:19], obs=blocks[2].obs[:19], mask=blocks[2].mask[:19]), 1e-6)
    for x, y in ((H1, H2), (b1, b2), (c1, c2)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=0)
    run = tba.make_distributed_ba(None, iters=5)
    got, gc = run(tp)
    want, wc = tba.ba_gauss_newton(tp, iters=5)
    assert torch.equal(gc, wc) and torch.equal(got.landmarks, want.landmarks)


def test_problem_from_vio_device(problems):
    """The problem goes to the CUDA card unless a device is named; without
    a card that raises.  Named, it converts with the JAX layout."""
    arrays = to_numpy(to_port(problems["clean"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tba.problem_from_vio(*arrays)
    prob = tba.problem_from_vio(*arrays, device="cpu")
    assert prob.landmarks.dtype == torch.float64 and prob.mask.dtype == torch.bool
    assert prob.obs.shape == (64, 6, 4)
