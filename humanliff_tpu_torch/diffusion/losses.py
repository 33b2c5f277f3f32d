"""Likelihood helpers (port of ``humanliff_tpu/diffusion/losses.py``; reference
improved_diffusion/losses.py)."""

from __future__ import annotations

import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal Gaussians, in nats (losses.py:12-39)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of images discretized to 1/255 buckets (losses.py:50-77);
    ``x`` is in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.reshape(x.shape[0], -1).mean(dim=1)
