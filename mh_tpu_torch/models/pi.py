"""Monte-Carlo pi estimator in plain PyTorch (counterpart of ``mh_tpu.models.pi``).

The re-creation of the NVIDIA ``MC_EstimatePiInlineP`` sample (SURVEY.md
B10; BASELINE.md measurement config 1): draw uniform points in the unit
square; the fraction inside the quarter disc estimates pi/4. The points
come from the layout sampler's threefry stream (:mod:`mh_tpu_torch.sampler.prng`),
batch ``i`` drawn as ``uniform(fold_in(key(seed), i), (batch, 2))``, as
``mh_tpu`` draws them: the same seed gives ``mh_tpu``'s points on any
device. Hits are counted exactly, as int64 (``mh_tpu`` counts in float32,
which drops low bits past 2^24 hits). The hand-written CUDA kernel for the
same job is :mod:`mh_tpu_torch.kernels.pi_kernel`.
"""

from __future__ import annotations

import torch

from mh_tpu_torch.sampler import prng


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
    key = prng.key(seed, device)
    hits = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(n_batches):
        pts = prng.uniform(prng.fold_in(key, i), (batch, 2))
        hits += torch.count_nonzero(torch.sum(torch.square(pts), dim=1) <= 1.0)
    return 4.0 * int(hits) / (n_batches * batch)
