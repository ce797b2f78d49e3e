"""NBB fractals (2D and 3D), the lambda/nu maps, the block layouts and the
engines."""
from repro_torch.core.baselines import BBEngine, LambdaEngine, life_rule
from repro_torch.core.compact import (MOORE_DIRS, BlockLayout,
                                      compact_to_expanded,
                                      expanded_to_compact)
from repro_torch.core.compact3d import BlockLayout3D
from repro_torch.core.fractals import (CARPET, CHANDELIER, EMPTY_BOTTLES,
                                       REGISTRY, SIERPINSKI, VICSEK,
                                       NBBFractal, get_fractal)
from repro_torch.core.fractals3d import (MENGER, REGISTRY3D, SIERPINSKI3D,
                                         NBBFractal3D)
from repro_torch.core.maps import (is_fractal, lambda_map, lambda_map_matmul,
                                   nu_map, nu_map_matmul, nu_with_membership)
from repro_torch.core.stencil import (KINDS, REFERENCE_KINDS,
                                      SqueezeBlockEngine, SqueezeCellEngine,
                                      SqueezeKernelEngine, default_fusion_k,
                                      make_engine)
from repro_torch.core.stencil3d import (BB3DEngine, Squeeze3DBlockEngine,
                                        Squeeze3DEngine,
                                        Squeeze3DKernelEngine)

__all__ = [
    "CARPET", "CHANDELIER", "EMPTY_BOTTLES", "REGISTRY", "SIERPINSKI",
    "VICSEK", "NBBFractal", "get_fractal", "is_fractal", "lambda_map",
    "lambda_map_matmul", "nu_map", "nu_map_matmul", "nu_with_membership",
    "BlockLayout", "MOORE_DIRS", "compact_to_expanded", "expanded_to_compact",
    "BlockLayout3D", "MENGER", "SIERPINSKI3D", "NBBFractal3D",
    "SqueezeBlockEngine", "SqueezeCellEngine", "SqueezeKernelEngine",
    "make_engine", "BBEngine", "LambdaEngine", "life_rule",
    "KINDS", "REFERENCE_KINDS", "default_fusion_k", "REGISTRY3D",
    "BB3DEngine", "Squeeze3DEngine", "Squeeze3DBlockEngine",
    "Squeeze3DKernelEngine",
]
