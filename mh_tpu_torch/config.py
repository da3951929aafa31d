"""Configuration, constants, and the parity/fixed mode switch.

The same constants and switches as ``mh_tpu.config``; see that module for
the reference lines each one reproduces (``Kernel.cu:31-39``) and for the
list of PARITY quirks that FIXED mode corrects.
"""

from __future__ import annotations

import dataclasses
import enum
import math

REF_PI: float = 3.1416  # Kernel.cu:31 — intentionally truncated
REF_BETA: float = 2.0  # Kernel.cu:33
REF_SIGMA_T: float = 15.0 / 90.0 * REF_PI  # Kernel.cu:39 (S_SIGMA_T)
TRUE_PI: float = math.pi

# Large-but-finite sentinel for the reference's DBL_MAX extents
# (Kernel.cu:345-363): only ever compared, never multiplied.
BIG: float = 1e30


class CostMode(enum.Enum):
    """Objective semantics: exact reference parity vs corrected math."""

    PARITY = "parity"
    FIXED = "fixed"

    @property
    def pi(self) -> float:
        return REF_PI if self is CostMode.PARITY else TRUE_PI


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampler configuration (replaces ``gpuConfig``, Kernel.cu:119-127).

    ``n_moves_per_step`` > 1 (compound block proposals) and
    ``accept_draws`` > 1 (the min-of-K accept rule) are valid settings that
    the port's fused kernel does not run yet; it raises for them.
    """

    iterations: int = 100
    n_chains: int = 1
    n_moves_per_step: int = 1
    accept_draws: int = 1
    beta: float = REF_BETA
    sigma_t: float = REF_SIGMA_T
    # Translation std = extent/16 (Kernel.cu:590-591); override if >0.
    sigma_xy_override: float = 0.0
    mode: CostMode = CostMode.PARITY
    # Step-size adaptation (off by default == reference behavior).
    adapt: bool = False
    target_accept: float = 0.44
    adapt_rate: float = 0.05

    def __post_init__(self) -> None:
        if self.iterations < 0 or self.n_chains < 1 or self.n_moves_per_step < 1:
            raise ValueError(f"invalid sampler config: {self}")
        if self.accept_draws < 1:
            raise ValueError(f"accept_draws must be >= 1: {self}")
