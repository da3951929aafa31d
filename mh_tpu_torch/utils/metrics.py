"""Sampler diagnostics: ESS and split R-hat (counterpart of ``mh_tpu.utils.metrics``).

The standard MCMC health metrics over the traces the samplers return, on
the traces' device, with ``mh_tpu``'s formulas: the autocorrelation at
lags 1 .. ``min(T - 1, 256)`` over the first ``T - max_lag`` samples,
truncated at the first lag that is not positive (Geyer's initial positive
sequence), and the split R-hat with ``ddof=1``. Traces come in and results
go out in float32; the sums accumulate in float64, so the lag where a
chain's autocorrelation is cut does not hang on the device's summation
order (an autocorrelation within a float32 rounding of zero would be cut
on one device and kept on another). Every function is batched over the
leading dims: the chains of a trace are one tensor op, not a loop.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _f64(traces) -> Tensor:
    """The float32 traces, widened for the sums."""
    return torch.as_tensor(traces).to(torch.float32).to(torch.float64)


def effective_sample_size(trace: Tensor, max_lag: int | None = None) -> Tensor:
    """ESS of scalar chain traces f32[..., T] via initial-positive-sequence
    autocorrelation; one value per chain, f32[...]."""
    trace = _f64(trace)
    t = trace.shape[-1]
    max_lag = max_lag or min(t - 1, 256)
    w = t - max_lag
    x = trace - torch.mean(trace, -1, keepdim=True)
    var = torch.clamp_min(torch.mean(torch.square(x), -1, keepdim=True), 1e-30)
    head = x[..., :w]
    rhos = torch.stack([torch.mean(head * x[..., lag:lag + w], -1)
                        for lag in range(1, max_lag + 1)], -1) / var
    # truncate at the first non-positive autocorrelation (Geyer-style)
    pos = torch.cumprod((rhos > 0).to(torch.float32), -1)
    tau = 1.0 + 2.0 * torch.sum(rhos * pos, -1)
    return (t / torch.clamp_min(tau, 1.0)).to(torch.float32)


def split_r_hat(traces: Tensor) -> Tensor:
    """Split R-hat over chain traces f32[C, T] (Gelman-Rubin, each chain
    split in half)."""
    traces = _f64(traces)
    half = traces.shape[1] // 2
    splits = torch.cat([traces[:, :half], traces[:, half:2 * half]])
    n = splits.shape[1]
    chain_means = torch.mean(splits, 1)
    chain_vars = torch.var(splits, 1, correction=1)
    b = n * torch.var(chain_means, correction=1)
    w = torch.mean(chain_vars)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp_min(w, 1e-30)).to(torch.float32)


def summarize_chains(cost_traces: Tensor) -> dict:
    """Summary of f32[C, T] cost traces: per-chain mean, std and ESS, and
    the split R-hat over the chains."""
    traces = _f64(cost_traces)
    return {
        "mean": torch.mean(traces, 1).to(torch.float32),
        "std": torch.std(traces, 1, correction=0).to(torch.float32),
        "ess": effective_sample_size(cost_traces),
        "r_hat": split_r_hat(cost_traces),
    }
