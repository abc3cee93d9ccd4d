"""Window extraction (kernel K2) of the port against the JAX package's Pallas
kernel, run in interpret mode as tests/test_patch_extract.py runs it.

A window copy is exact, so every comparison is bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_stereo_c_torch.ops.patch_extract import extract_windows
from msckf_stereo_c_tpu.ops.patch_extract import extract_patches_pallas

torch.set_num_threads(1)


def _origins(rng, H, W, S, N):
    org = np.stack([rng.integers(0, W - S + 1, N), rng.integers(0, H - S + 1, N)], axis=1)
    # The clip limits of both axes and their corners.
    org[:4] = [[0, 0], [W - S, 0], [0, H - S], [W - S, H - S]]
    return org.astype(np.int32)


@pytest.mark.parametrize("shape", [(480, 752), (60, 94)])
@pytest.mark.parametrize("S", [18, 35, 37])
def test_matches_pallas(shape, S):
    H, W = shape
    rng = np.random.default_rng(S)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    org = _origins(rng, H, W, S, 21)
    want = extract_patches_pallas(jnp.asarray(img), jnp.asarray(org), S, interpret=True)
    got = extract_windows(torch.as_tensor(img), torch.as_tensor(org), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_range_origins_clamp():
    """The port clamps origins into [0, W-S] x [0, H-S] itself: on the card
    an unclamped origin would read outside the image.  Past the far edge
    this is the clamp of the JAX callers' lax.dynamic_slice.  A negative
    start, which the JAX callers never pass (they clip first), wraps
    NumPy-style in lax.dynamic_slice before its clamp; the port clamps it
    to 0."""
    H, W, S = 60, 94, 35
    img = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
    far = np.array([[W, H], [W - S + 1, 3], [5, H - S + 2]], np.int32)
    want = jax.vmap(lambda o: jax.lax.dynamic_slice(jnp.asarray(img), (o[1], o[0]), (S, S)))(
        jnp.asarray(far)
    )
    got = extract_windows(torch.as_tensor(img), torch.as_tensor(far), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    neg = np.array([[-3, 0], [W - S + 1, -7]], np.int32)
    got = extract_windows(torch.as_tensor(img), torch.as_tensor(neg), S).numpy()
    np.testing.assert_array_equal(got[0], img[0:S, 0:S])
    np.testing.assert_array_equal(got[1], img[0:S, W - S:W])


def test_flat_feature_axis_with_image_index():
    """A (B, H, W) stack with a per-window image index gives what the JAX
    package's vmap over per-sequence images gives."""
    B, H, W, S, N = 2, 120, 188, 18, 9
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    org = np.stack([_origins(rng, H, W, S, N) for _ in range(B)])
    want = jax.vmap(lambda im, o: extract_patches_pallas(im, o, S, interpret=True))(
        jnp.asarray(imgs), jnp.asarray(org)
    )
    index = torch.arange(B, dtype=torch.int32).repeat_interleave(N)
    got = extract_windows(torch.as_tensor(imgs), torch.as_tensor(org.reshape(B * N, 2)), S, index)
    np.testing.assert_array_equal(got.numpy().reshape(B, N, S, S), np.asarray(want))
