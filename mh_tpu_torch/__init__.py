"""mh_tpu_torch — the Metropolis-Hastings scene-layout engine in PyTorch + CUDA.

The port of ``mh_tpu`` to one NVIDIA Hopper GPU, with the same public
names for what it has so far: the scene model and its JSON format, the
seven-term objective in PARITY and FIXED modes, the chain engine on
``jax.random``'s threefry stream (``sampler/``: ``run_chains``,
``compile_chains`` as a CUDA graph, parallel tempering and annealed SMC),
``suggest_layouts`` over that engine or the fused MH chain kernel
(``kernels/csrc/fused_mh.cu``; single or compound moves, one or K accept
draws), the chains, replicas, particles and object rows split over a mesh
of devices in one process (``parallel/``), JSONL run logging, the
Monte-Carlo pi estimator with its CUDA kernel
(``kernels/csrc/pi_kernel.cu``), and the ``python -m mh_tpu_torch``
command line. Each kernel has a plain PyTorch version that
runs on the CPU. It imports neither ``jax`` nor ``mh_tpu``.
"""

from mh_tpu_torch.config import CostMode, SamplerConfig, REF_PI, REF_BETA
from mh_tpu_torch.models.scene import (
    RectSet,
    Scene,
    SceneSpec,
    rects_from_vertices,
    demo_scene,
    scene_from_numpy,
)
from mh_tpu_torch.ops.costs import CostBreakdown, cost_terms, total_cost
from mh_tpu_torch.sampler.mh import (
    MHState,
    compile_chains,
    mh_init,
    mh_step,
    run_chain,
    run_chains,
)
from mh_tpu_torch.api import LayoutResult, suggest_layouts
from mh_tpu_torch.models.pi import estimate_pi

__version__ = "0.1.0"

__all__ = [
    "CostMode",
    "SamplerConfig",
    "REF_PI",
    "REF_BETA",
    "RectSet",
    "Scene",
    "SceneSpec",
    "rects_from_vertices",
    "demo_scene",
    "scene_from_numpy",
    "CostBreakdown",
    "cost_terms",
    "total_cost",
    "MHState",
    "compile_chains",
    "mh_init",
    "mh_step",
    "run_chain",
    "run_chains",
    "LayoutResult",
    "suggest_layouts",
    "estimate_pi",
]
