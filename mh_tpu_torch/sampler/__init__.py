"""Samplers: the MH chain engine, tempering / SMC and the gradient samplers.

- :mod:`mh_tpu_torch.sampler.prng` — ``jax.random``'s threefry stream
- :mod:`mh_tpu_torch.sampler.proposal` — translate/rotate/swap block proposals
- :mod:`mh_tpu_torch.sampler.mh` — the chain engine (chains as a leading dim)
- :mod:`mh_tpu_torch.sampler.tempering` — parallel tempering over a device mesh
- :mod:`mh_tpu_torch.sampler.smc` — annealed SMC over a device mesh
- :mod:`mh_tpu_torch.sampler.hmc` — leapfrog HMC with dual-averaging warmup
- :mod:`mh_tpu_torch.sampler.nuts` — multinomial NUTS (stored-subtree doubling)
- :mod:`mh_tpu_torch.sampler.mala` — Metropolis-adjusted Langevin (one grad/step)
- :mod:`mh_tpu_torch.sampler.vi` — mean-field Gaussian VI
- :mod:`mh_tpu_torch.sampler.generic` — RW-MH over batched log-densities, the
  layout objective as one
- :mod:`mh_tpu_torch.sampler.incremental` — exact delta-cost variant (see its
  docstring)
"""

from mh_tpu_torch.sampler.mh import (
    MHState,
    compile_chains,
    mh_init,
    mh_step,
    run_chain,
    run_chains,
)
from mh_tpu_torch.sampler.tempering import geometric_ladder, run_tempered
from mh_tpu_torch.sampler.smc import run_smc
from mh_tpu_torch.sampler.hmc import hmc_sample
from mh_tpu_torch.sampler.nuts import nuts_sample
from mh_tpu_torch.sampler.mala import mala_sample
from mh_tpu_torch.sampler.vi import meanfield_vi
from mh_tpu_torch.sampler.generic import layout_logdensity, rw_metropolis
