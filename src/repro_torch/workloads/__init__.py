"""Stencil workloads and the batched runner."""
from repro_torch.workloads.base import StencilWorkload, weighted_moore_agg
from repro_torch.workloads.rules import (GRAY_SCOTT, HEAT, HEAT3D, HIGHLIFE,
                                         LIFE, LIFE3D, SEEDS, WORKLOADS,
                                         WORKLOADS3D, GrayScott,
                                         HeatDiffusion, TotalisticCA,
                                         get_workload, life_rule)
from repro_torch.workloads.runner import (BatchedRunner, RunnerStats,
                                          default_runner)

__all__ = [
    "StencilWorkload", "weighted_moore_agg", "TotalisticCA",
    "HeatDiffusion", "GrayScott", "LIFE", "HIGHLIFE", "SEEDS", "HEAT",
    "GRAY_SCOTT", "LIFE3D", "HEAT3D", "WORKLOADS", "WORKLOADS3D",
    "get_workload", "life_rule", "BatchedRunner", "RunnerStats",
    "default_runner",
]
