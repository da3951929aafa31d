"""Samplers: the MH chain engine, parallel tempering and annealed SMC.

- :mod:`mh_tpu_torch.sampler.prng` — ``jax.random``'s threefry stream
- :mod:`mh_tpu_torch.sampler.proposal` — translate/rotate/swap block proposals
- :mod:`mh_tpu_torch.sampler.mh` — the chain engine (chains as a leading dim)
- :mod:`mh_tpu_torch.sampler.tempering` — parallel tempering over a device mesh
- :mod:`mh_tpu_torch.sampler.smc` — annealed SMC over a device mesh
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
