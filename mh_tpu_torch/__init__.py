"""mh_tpu_torch — the Metropolis-Hastings scene-layout engine in PyTorch + CUDA.

The port of ``mh_tpu`` to one NVIDIA Hopper GPU, with the same public
names for what it has so far: the scene model, the seven-term objective
in PARITY and FIXED modes, and ``suggest_layouts`` over the fused MH chain
kernel (``kernels/csrc/fused_mh.cu``, with a plain PyTorch version that
runs on the CPU). It imports neither ``jax`` nor ``mh_tpu``.
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
from mh_tpu_torch.api import LayoutResult, suggest_layouts

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
    "LayoutResult",
    "suggest_layouts",
]
