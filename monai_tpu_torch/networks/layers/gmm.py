"""A Gaussian mixture model a class, for interactive segmentation (counterpart of
monai_tpu/networks/layers/gmm.py): EM on dense products and ``torch.linalg.solve`` /
``slogdet``, the JAX package's initialisation, iteration count and eps, on the features'
device. No kernel: the JAX package runs it through XLA."""
from __future__ import annotations

import math

import torch

__all__ = ["GaussianMixtureModel"]

_EPS = 1e-6


def _log_gauss(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, cov + eps I) of the rows of ``x`` (N, F)."""
    diff = x - mean[None]
    cov_r = cov + _EPS * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    maha = (diff * torch.linalg.solve(cov_r, diff.T).T).sum(dim=1)
    return -0.5 * (maha + torch.linalg.slogdet(cov_r)[1] + cov.shape[0] * math.log(2 * math.pi))


class GaussianMixtureModel:
    """``mixture_count`` classes of ``mixture_size`` Gaussians each over ``channel_count``
    features. ``learn(features (B, F, N), labels (B, N))`` fits each class's mixture to
    its labelled points (label -1: unlabelled) by ``n_iter`` EM steps; ``apply(features)``
    gives each class's posterior, (B, K, N)."""

    def __init__(self, channel_count: int, mixture_count: int, mixture_size: int, verbose_build: bool = False):
        self.channel_count = channel_count
        self.mixture_count = mixture_count
        self.mixture_size = mixture_size
        self.params = None

    def _fit_single(self, feats: torch.Tensor, labels: torch.Tensor, n_iter: int):
        """EM for one image: feats (F, N), labels (N,). Each class starts from its points'
        mean and per-feature std, its components' means spread over ±1 std."""
        nf = feats.shape[0]
        k, m = self.mixture_count, self.mixture_size
        eye = torch.eye(nf, dtype=feats.dtype, device=feats.device)
        offsets = torch.linspace(-1.0, 1.0, m, dtype=feats.dtype, device=feats.device)[:, None]
        means, covs, weights = [], [], []
        for c in range(k):
            mask = (labels == c).to(feats.dtype)
            count = mask.sum().clamp_min(1.0)
            mean = (feats * mask).sum(dim=1) / count
            std = torch.sqrt(((feats - mean[:, None]) ** 2 * mask).sum(dim=1) / count + _EPS)
            means.append(mean[None] + offsets * std[None])
            covs.append(torch.diag(std ** 2 + _EPS)[None].repeat(m, 1, 1))
            weights.append(torch.full((m,), 1.0 / m, dtype=feats.dtype, device=feats.device))
        means, covs, weights = torch.stack(means), torch.stack(covs), torch.stack(weights)
        x = feats.T
        for _ in range(n_iter):
            new_means, new_covs, new_weights = [], [], []
            for c in range(k):
                mask = (labels == c).to(feats.dtype)
                logp = torch.stack([_log_gauss(x, means[c, j], covs[c, j]) + torch.log(weights[c, j] + _EPS)
                                    for j in range(m)])
                resp = torch.softmax(logp, dim=0) * mask[None]
                nk = resp.sum(dim=1) + _EPS
                mu = (resp @ x) / nk[:, None]
                diffs = x[None] - mu[:, None]
                cov = torch.einsum("mn,mnf,mng->mfg", resp, diffs, diffs) / nk[:, None, None] + _EPS * eye[None]
                new_means.append(mu)
                new_covs.append(cov)
                new_weights.append(nk / nk.sum())
            means, covs, weights = torch.stack(new_means), torch.stack(new_covs), torch.stack(new_weights)
        return means, covs, weights

    def learn(self, features: torch.Tensor, labels: torch.Tensor, n_iter: int = 10) -> None:
        """Fit the mixtures of each image of the batch."""
        fits = [self._fit_single(f, l, n_iter) for f, l in zip(features.float(), labels)]
        self.params = tuple(torch.stack(p) for p in zip(*fits))

    def apply(self, features: torch.Tensor) -> torch.Tensor:
        """Each class's posterior probability at each point, (B, K, N)."""
        if self.params is None:
            raise RuntimeError("GMM must be fit with learn() before apply().")
        outs = []
        for feats, means, covs, weights in zip(features.float(), *self.params):
            x = feats.T
            eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
            logp = []
            for c in range(self.mixture_count):
                comp = []
                for j in range(self.mixture_size):
                    cov_r = covs[c, j] + _EPS * eye
                    diff = x - means[c, j][None]
                    maha = (diff * torch.linalg.solve(cov_r, diff.T).T).sum(dim=1)
                    comp.append(torch.log(weights[c, j] + _EPS) - 0.5 * (maha + torch.linalg.slogdet(cov_r)[1]))
                logp.append(torch.logsumexp(torch.stack(comp), dim=0))
            outs.append(torch.softmax(torch.stack(logp), dim=0))
        return torch.stack(outs)
