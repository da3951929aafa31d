"""The Monte-Carlo pi estimator as one CUDA kernel (BASELINE config 1).

Counterpart of ``mh_tpu.kernels.pi_kernel`` (the Pallas ``_pi_kernel``).
:func:`estimate_pi_fused` counts, over ``total`` points of 23-bit uniforms,
those with ``x*x + y*y <= 1`` (f32, no fused multiply-add):

- on a CUDA device it launches ``csrc/pi_kernel.cu`` (built by ``nvcc`` at
  first use) and raises if the launch fails;
- on the CPU it runs :func:`pi_hits_reference`, the plain PyTorch version.

The TPU kernel draws from the TPU's hardware generator, which no other
device reproduces. Both versions here key each coordinate by (seed, sample
index, coordinate) through the counter hash of the fused MH kernel
(``counter_rng``): sample s takes draw counter ``s >> 31`` and flat indices
``2s`` (x) and ``2s + 1`` (y) modulo 2^32. So the kernel and the plain
version count exactly the same hits. Hits stay integers end to end.
"""

from __future__ import annotations

import ctypes

import torch

from mh_tpu_torch.kernels import _build
from mh_tpu_torch.kernels.counter_rng import M32, counter_bits

TILE_N = 256 * 128  # samples per grid step and draw of mh_tpu's kernel
BLOCKS_PER_SM = 8  # CUDA blocks of 256 threads per SM: 2048 threads, the SM's maximum
_CHUNK = 1 << 22  # samples per batch of the plain version


def pi_total(n_samples: int, grid: int = 8) -> int:
    """``n_samples`` rounded up to a whole number of ``TILE_N * grid`` tiles,
    the count ``mh_tpu``'s kernel draws for the same arguments."""
    if n_samples < 1 or grid < 1:
        raise ValueError(f"n_samples={n_samples} and grid={grid} must be positive")
    return -(-n_samples // (TILE_N * grid)) * TILE_N * grid


def pi_hits_reference(seed: int, total: int, device=None) -> int:
    """The plain PyTorch version: hits among samples ``[0, total)``."""
    pi_hits_reference.calls += 1
    hits = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, total, _CHUNK):
        s = torch.arange(start, min(start + _CHUNK, total), dtype=torch.int64, device=device)
        counter = s >> 31
        flat = (s << 1) & M32
        x = counter_bits(seed, counter, flat).to(torch.float32) * (1.0 / (1 << 23))
        y = counter_bits(seed, counter, flat | 1).to(torch.float32) * (1.0 / (1 << 23))
        hits += torch.count_nonzero(x * x + y * y <= 1.0)
    return int(hits)


pi_hits_reference.calls = 0


def pi_hits_cuda(seed: int, total: int, device="cuda") -> int:
    """Launch ``csrc/pi_kernel.cu`` for samples ``[0, total)`` on a CUDA device.

    Same contract as :func:`pi_hits_reference`. Raises on a non-CUDA device
    and on a failed launch.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"pi_hits_cuda needs a CUDA device, got {device}")
    if not 0 <= total < 2**63:
        raise ValueError(f"total={total} out of range")
    n_blocks = torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM
    lib = _build.load()
    partial = torch.empty(n_blocks, dtype=torch.int64, device=device)
    with torch.cuda.device(partial.device):  # the entry point launches on the current device
        err = lib.mh_pi_hits(
            ctypes.c_void_p(partial.data_ptr()), n_blocks, ctypes.c_uint32(seed & M32), total,
            ctypes.c_void_p(torch.cuda.current_stream(partial.device).cuda_stream),
        )
    pi_hits_cuda.launches += 1
    if err:
        raise RuntimeError(f"pi kernel launch failed: {_build.error_string(err)}")
    return int(partial.sum())


pi_hits_cuda.launches = 0


def estimate_pi_fused(seed: int, n_samples: int = 1 << 30, grid: int = 8, device="cuda"):
    """Estimate pi with the kernel: ``(estimate, total)``.

    ``n_samples`` rounds up as ``mh_tpu``'s does (:func:`pi_total`), so
    ``total`` equals its count for the same arguments; ``grid`` only sets
    that rounding. ``device`` picks the CUDA kernel (the default) or, for
    ``"cpu"``, the plain version.
    """
    total = pi_total(n_samples, grid)
    device = torch.device(device)
    if device.type == "cuda":
        hits = pi_hits_cuda(seed, total, device)
    elif device.type == "cpu":
        hits = pi_hits_reference(seed, total, device)
    else:
        raise ValueError(f"unsupported device {device}")
    return 4.0 * hits / total, total
