"""NBB fractals, the lambda/nu maps, the block layout and the engines."""
from repro_torch.core.baselines import BBEngine, LambdaEngine
from repro_torch.core.compact import BlockLayout
from repro_torch.core.fractals import (CARPET, REGISTRY, SIERPINSKI, VICSEK,
                                       NBBFractal, get_fractal)
from repro_torch.core.stencil import (KINDS, REFERENCE_KINDS,
                                      SqueezeBlockEngine, SqueezeCellEngine,
                                      SqueezeKernelEngine, default_fusion_k,
                                      make_engine)

__all__ = [
    "BBEngine", "LambdaEngine", "BlockLayout", "CARPET", "REGISTRY",
    "SIERPINSKI", "VICSEK", "NBBFractal", "get_fractal", "KINDS",
    "REFERENCE_KINDS", "SqueezeBlockEngine", "SqueezeCellEngine",
    "SqueezeKernelEngine", "default_fusion_k", "make_engine",
]
