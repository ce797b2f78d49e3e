"""LM substrate: the config-driven model zoo (dense / MoE / SSM / hybrid /
enc-dec / VLM backbone) in plain PyTorch, one ``nn.Module`` a layer kind
and a model family, with the reference's module-level functions."""
from repro_torch.models.config import (LayerSpec, ModelConfig, MoESpec,
                                       RecSpec, SSMSpec)
from repro_torch.models.model import (decode_step, forward, generate,
                                      greedy_generate, init_cache,
                                      init_params, prefill, train_loss)

__all__ = ["LayerSpec", "ModelConfig", "MoESpec", "RecSpec", "SSMSpec",
           "decode_step", "forward", "generate", "greedy_generate",
           "init_cache", "init_params", "prefill", "train_loss"]
