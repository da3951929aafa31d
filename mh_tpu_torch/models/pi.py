"""Monte-Carlo pi estimator in plain PyTorch (counterpart of ``mh_tpu.models.pi``).

The re-creation of the NVIDIA ``MC_EstimatePiInlineP`` sample (SURVEY.md
B10; BASELINE.md measurement config 1): draw uniform points in the unit
square; the fraction inside the quarter disc estimates pi/4. The points
come from a ``torch.Generator`` seeded explicitly, in fixed-size batches,
so the same seed gives the same estimate on one device. The hand-written
CUDA kernel for the same job is :mod:`mh_tpu_torch.kernels.pi_kernel`.
"""

from __future__ import annotations

import torch


def estimate_pi(seed: int, n_samples: int = 1 << 20, batch: int = 1 << 16,
                device="cuda") -> float:
    """Estimate pi from ``n_samples`` points (rounded up to whole batches).

    Runs on the card unless ``device`` names another; without a card the
    default raises rather than falling back to the CPU. Batching keeps
    memory flat for large sample counts; hits are counted as integers, so
    the count is exact at any size.
    """
    if n_samples < 1 or batch < 1:
        raise ValueError(f"n_samples={n_samples} and batch={batch} must be positive")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    n_batches = -(-n_samples // batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    hits = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(n_batches):
        pts = torch.rand(batch, 2, generator=gen, device=device)
        hits += torch.count_nonzero(torch.sum(torch.square(pts), dim=1) <= 1.0)
    return 4.0 * int(hits) / (n_batches * batch)
