"""Standard target densities (counterpart of ``mh_tpu.models.densities``).

Generic densities beside the layout objective, used to check the gradient
samplers statistically (known moments, curved shapes). Each returns a
batched log-density: ``theta [..., D] -> [...]``. Its constants are
float32 and follow ``theta`` to its device (one copy per device).
"""

from __future__ import annotations

import numpy as np
import torch

from mh_tpu_torch.sampler.prng import f32

Tensor = torch.Tensor


def _on_device(a):
    """``a`` as float32, copied to a device the first time it is asked for."""
    host = torch.as_tensor(np.asarray(a, np.float32))
    copies: dict = {}

    def on(device: torch.device) -> Tensor:
        if device not in copies:
            copies[device] = host.to(device)
        return copies[device]

    return on


def gaussian(mean, cov_diag):
    mean, cov = _on_device(mean), _on_device(cov_diag)

    def logdensity(theta: Tensor) -> Tensor:
        d = theta.device
        return -0.5 * torch.sum(torch.square(theta - mean(d)) / cov(d), -1)

    return logdensity


def banana(a: float = 1.0, b: float = 0.3):
    """Rosenbrock-style banana in 2D (curved posterior shape)."""
    a, b, aa = f32(a), f32(b), f32(a * a)  # JAX rounds the Python product

    def logdensity(theta: Tensor) -> Tensor:
        x, y = theta[..., 0], theta[..., 1]
        return -0.5 * (torch.square(x / a) + torch.square(a * (y - b * (x * x + aa))))

    return logdensity


def gaussian_mixture(means, sigma: float = 1.0):
    log_k = f32(np.log(np.float32(np.shape(means)[0])))
    means = _on_device(means)  # [K, D]
    var = f32(sigma * sigma)

    def logdensity(theta: Tensor) -> Tensor:
        d2 = torch.sum(torch.square(theta[..., None, :] - means(theta.device)), -1)
        return torch.logsumexp(-0.5 * d2 / var, -1) - log_k

    return logdensity

