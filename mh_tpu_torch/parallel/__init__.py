"""Parallelism: device meshes, sharded chain runners and their collectives.

Counterpart of ``mh_tpu.parallel``: chains, replicas, particles and object
rows split over a :class:`~mh_tpu_torch.parallel.mesh.Mesh` of torch
devices, with collective acceptance-rate adaptation (psum), parallel
tempering (ppermute exchange) and SMC resampling (all_gather), in one
process or, over ``torch.distributed``, across processes
(:mod:`mh_tpu_torch.parallel.multihost`).
"""

from mh_tpu_torch.parallel.mesh import chain_mesh, device_report
from mh_tpu_torch.parallel.multihost import global_chain_mesh, initialize, process_allgather
from mh_tpu_torch.parallel.sharded import run_chains_collective, run_chains_sharded
