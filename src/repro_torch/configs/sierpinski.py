"""The paper's own case study: Conway's game of life on a discrete
Sierpinski triangle F^{3,2} in compact space (Squeeze engine). This is a
fractal-simulation config, not an LM config -- see ``core/`` and
``examples/torch/``."""
import dataclasses

from repro_torch.core.fractals import SIERPINSKI


@dataclasses.dataclass(frozen=True)
class FractalConfig:
    fractal: str = "sierpinski"
    r: int = 10            # level (n = 2^r); paper sweeps r in [0, 20]
    m: int = 4             # block level: rho = s^m = 16 (paper's best)
    steps: int = 1000      # paper: 1000 iterations per run
    engine: str = "block"  # "bb" | "lambda" | "cell" | "block"


CONFIG = FractalConfig()
FRACTAL = SIERPINSKI
