"""Mean-field Gaussian variational inference (counterpart of
``mh_tpu.sampler.vi``).

Reparameterized ELBO maximization with Adam on any batched log-density,
the layout objective included
(:func:`mh_tpu_torch.sampler.generic.layout_logdensity`): the ``n_mc``
draws of a step go through the log-density in one call. Adam is written
out in optax's order of operations (bias-corrected ``m / (sqrt(v) +
eps)``, then times ``-lr``), which is not ``torch.optim.Adam``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.generic import LogDensity, start_point

Tensor = torch.Tensor


def elbo(key: Tensor, mu: Tensor, log_sigma: Tensor, logdensity_fn: LogDensity,
         n_mc: int) -> Tensor:
    """Monte-Carlo ELBO with the reparameterization trick."""
    f = np.float32
    eps = prng.normal(key, (n_mc, mu.shape[-1]))
    lps = logdensity_fn(prng.fma(eps, torch.exp(log_sigma), mu))
    entropy_const = f(0.5 * mu.shape[-1]) * (f(1.0) + np.log(f(2.0 * math.pi)))
    return torch.mean(lps) + (torch.sum(log_sigma) + float(entropy_const))


class Adam:
    """``optax.adam(lr)`` on a list of tensors: b1 = 0.9, b2 = 0.999,
    eps = 1e-8, the step count starting at 1."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.m = self.v = None

    def update(self, params: list[Tensor], grads: list[Tensor]) -> list[Tensor]:
        f32 = prng.f32
        if self.m is None:
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = f32(1 - self.b1) * g + f32(self.b1) * self.m[i]
            self.v[i] = f32(1 - self.b2) * (g * g) + f32(self.b2) * self.v[i]
            upd = (self.m[i] / bc1) / (torch.sqrt(self.v[i] / bc2) + f32(self.eps))
            out.append(p + f32(-self.lr) * upd)
        return out


def meanfield_vi(
    key,
    logdensity_fn: LogDensity,
    theta0,
    n_steps: int = 500,
    n_mc: int = 8,
    learning_rate: float = 0.05,
    init_log_sigma: float = -1.0,
    device=None,
):
    """Fit N(mu, diag(sigma^2)) by maximizing the ELBO.

    Returns ``(mu, sigma, elbo_trace f32[n_steps])``.
    """
    key, mu = start_point(key, theta0, device)
    ls = torch.full_like(mu, prng.f32(init_log_sigma))
    opt = Adam(learning_rate)
    trace = mu.new_empty(n_steps)
    for i in range(n_steps):
        with torch.enable_grad():
            mu_, ls_ = mu.detach().requires_grad_(True), ls.detach().requires_grad_(True)
            value = elbo(prng.fold_in(key, i), mu_, ls_, logdensity_fn, n_mc)
            g_mu, g_ls = torch.autograd.grad(-value, (mu_, ls_))
        mu, ls = opt.update([mu, ls], [g_mu, g_ls])
        trace[i] = value.detach()
    return mu, torch.exp(ls), trace
