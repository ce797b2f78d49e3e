"""NBB fractals (2D and 3D), the lambda/nu maps, the block layouts and the
engines."""
from repro_torch.core.baselines import BBEngine, LambdaEngine
from repro_torch.core.compact import BlockLayout
from repro_torch.core.compact3d import BlockLayout3D
from repro_torch.core.fractals import (CARPET, REGISTRY, SIERPINSKI, VICSEK,
                                       NBBFractal, get_fractal)
from repro_torch.core.fractals3d import (MENGER, REGISTRY3D, SIERPINSKI3D,
                                         NBBFractal3D)
from repro_torch.core.stencil import (KINDS, REFERENCE_KINDS,
                                      SqueezeBlockEngine, SqueezeCellEngine,
                                      SqueezeKernelEngine, default_fusion_k,
                                      make_engine)
from repro_torch.core.stencil3d import (BB3DEngine, Squeeze3DBlockEngine,
                                        Squeeze3DEngine,
                                        Squeeze3DKernelEngine)

__all__ = [
    "BBEngine", "LambdaEngine", "BlockLayout", "CARPET", "REGISTRY",
    "SIERPINSKI", "VICSEK", "NBBFractal", "get_fractal", "KINDS",
    "REFERENCE_KINDS", "SqueezeBlockEngine", "SqueezeCellEngine",
    "SqueezeKernelEngine", "default_fusion_k", "make_engine",
    "BlockLayout3D", "MENGER", "REGISTRY3D", "SIERPINSKI3D", "NBBFractal3D",
    "BB3DEngine", "Squeeze3DEngine", "Squeeze3DBlockEngine",
    "Squeeze3DKernelEngine",
]
