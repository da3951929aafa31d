"""Parallelism: device meshes, sharded chain runners and their collectives.

Counterpart of ``mh_tpu.parallel`` for one process: chains, replicas,
particles and object rows split over a :class:`~mh_tpu_torch.parallel.mesh.Mesh`
of torch devices, with collective acceptance-rate adaptation (psum),
parallel tempering (ppermute exchange) and SMC resampling (all_gather).
"""

from mh_tpu_torch.parallel.mesh import chain_mesh, device_report
from mh_tpu_torch.parallel.sharded import run_chains_collective, run_chains_sharded
