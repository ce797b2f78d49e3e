"""The Hopper kernels and their build."""
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.lambda_map import lambda_map_tc
from repro_torch.kernels.nu_map import nu_map_tc
from repro_torch.kernels.squeeze_stencil import (life_step_blocks,
                                                 life_step_strips)

__all__ = ["flash_attention", "lambda_map_tc", "life_step_blocks",
           "life_step_strips", "nu_map_tc"]
