"""The port's GaussianMixtureModel and permutohedral_filter's ``sigmas`` against monai_tpu's.

- ``learn`` then ``apply`` on a batch of 2 images of 3 features over 16x16 points, 3 classes
  of 2 components each, a third of the points labelled: both packages' EM in float32 (a
  ``solve`` and a ``slogdet`` a component and step, 10 steps), the fitted means, covariances
  and weights within 1e-4 of max|ref| and the posteriors within 1e-4 absolute (float32 sums
  in another order, carried through the EM steps); and on (1, 3, 64^2) features, the size
  the card's check uses.
- ``apply`` before ``learn`` raises.
- ``permutohedral_filter(data, features, sigmas)`` against the JAX package's, within 1e-5 of
  max|ref|: the features divided by their sigmas before the lattice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monai_tpu.networks.layers.gmm import GaussianMixtureModel as JaxGMM
from monai_tpu.ops.permutohedral import permutohedral_filter as jax_permutohedral
from monai_tpu_torch.networks.layers import GaussianMixtureModel
from monai_tpu_torch.ops.permutohedral import permutohedral_filter


def _features(b: int, n: int, seed: int):
    """Features drawn around a class mean each, and labels of which about a third are known."""
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, 3, (b, n))
    centres = np.array([[0.0, 0.0, 0.0], [2.0, -1.0, 0.5], [-1.5, 1.5, 2.0]])
    feats = (centres[cls] + rng.randn(b, n, 3) * 0.6).transpose(0, 2, 1).astype(np.float32)
    labels = np.where(rng.rand(b, n) < 0.35, cls, -1).astype(np.int32)
    return feats, labels


@pytest.mark.parametrize("b,n", [(2, 256), (1, 64 * 64)])
def test_gmm_learn_and_apply_match_jax(b, n):
    feats, labels = _features(b, n, n)
    ref = JaxGMM(3, 3, 2)
    ref.learn(jnp.asarray(feats), jnp.asarray(labels))
    gmm = GaussianMixtureModel(3, 3, 2)
    gmm.learn(torch.from_numpy(feats), torch.from_numpy(labels))
    for got, want in zip(gmm.params, ref.params):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    post = gmm.apply(torch.from_numpy(feats))
    want = np.asarray(ref.apply(jnp.asarray(feats)))
    assert post.shape == (b, 3, n) and np.abs(post.numpy() - want).max() <= 1e-4
    np.testing.assert_allclose(post.sum(1).numpy(), 1.0, atol=1e-5)


def test_gmm_apply_before_learn_raises():
    with pytest.raises(RuntimeError):
        GaussianMixtureModel(3, 2, 2).apply(torch.zeros(1, 3, 4))


@pytest.mark.parametrize("sigmas", [(2.0, 0.5, 1.5), (0.7, 3.0, 1.0)])
def test_permutohedral_sigmas_match_jax(sigmas):
    rng = np.random.RandomState(3)
    data = rng.rand(1, 2, 10, 12).astype(np.float32)
    features = rng.rand(1, 3, 10, 12).astype(np.float32) * 4
    ref = np.asarray(jax_permutohedral(jnp.asarray(data), jnp.asarray(features), sigmas))
    got = permutohedral_filter(torch.from_numpy(data), torch.from_numpy(features), sigmas).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
