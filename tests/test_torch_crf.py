"""monai_tpu_torch's CRF against monai_tpu's, on the CPU, in float32.

Two mean-field iterations over the PHL filter: on (1, 2, 17, 17, 17) logits (4,913
voxels, above the exact path's 4,096, so the feature grid: the bilateral features are
F = 4, the Gaussian ones F = 3) and on (1, 3, 16, 16) logits (256 voxels, the exact
path), each with and without a compatibility matrix. Tolerance 1e-4 absolute on the probabilities: the grid's scatter
sums run in another order. The JAX CRF is jitted, as its eager loop over the PHL filter
costs seconds a call here.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monai_tpu.networks.blocks.crf import CRF as JaxCRF
from monai_tpu_torch.networks.blocks import CRF


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    ref = rng.rand(shape[0], 1, *shape[2:]).astype(np.float32)
    ref[..., : shape[2] // 2, :] += 1.0  # two regions, one brighter
    logits = (rng.randn(*shape) + np.concatenate([ref, -ref, ref * 0.5][: shape[1]], axis=1)).astype(np.float32)
    return logits, ref


@pytest.mark.parametrize("shape", [(1, 2, 17, 17, 17), (1, 3, 16, 16)])
@pytest.mark.parametrize("compat", [False, True])
def test_crf_matches_jax(shape, compat):
    logits, ref = _inputs(shape, seed=len(shape))
    c = shape[1]
    matrix = (1.0 - np.eye(c, dtype=np.float32)) * -0.5 + np.eye(c, dtype=np.float32) if compat else None
    jax_crf = JaxCRF(iterations=2, compatibility_matrix=None if matrix is None else jnp.asarray(matrix))
    expected = np.asarray(jax.jit(jax_crf.__call__)(jnp.asarray(logits), jnp.asarray(ref)))
    got = CRF(iterations=2, compatibility_matrix=matrix)(torch.from_numpy(logits), torch.from_numpy(ref))
    assert got.shape == logits.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy().sum(axis=1), 1.0, atol=1e-5)


def test_crf_weights_and_sigmas():
    """Non-default weights, sigmas and update factor reach both filters."""
    logits, ref = _inputs((2, 2, 12, 10), seed=7)
    kwargs = dict(iterations=3, bilateral_weight=0.7, gaussian_weight=1.6, bilateral_spatial_sigma=2.0,
                  bilateral_color_sigma=0.3, gaussian_spatial_sigma=1.5, update_factor=2.0)
    expected = np.asarray(jax.jit(JaxCRF(**kwargs).__call__)(jnp.asarray(logits), jnp.asarray(ref)))
    got = CRF(**kwargs)(torch.from_numpy(logits), torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-4)
