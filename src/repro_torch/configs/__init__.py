"""Architecture registry: the 10 assigned archs (+ the paper's own
Sierpinski case study). ``get_config(arch_id)`` returns the exact full
config; ``get_smoke_config`` the reduced CPU-runnable one."""
from __future__ import annotations

import importlib

from repro_torch.configs.common import SHAPES, reduced
from repro_torch.models.config import ModelConfig

#: arch id -> module name
ARCHS = {
    "mixtral-8x22b": "mixtral_8x22b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "whisper-small": "whisper_small",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma2-2b": "gemma2_2b",
    "smollm-135m": "smollm_135m",
    "llava-next-34b": "llava_next_34b",
}

#: long_500k policy: sub-quadratic archs only
LONG_CONTEXT_ARCHS = ("mixtral-8x22b", "recurrentgemma-9b", "mamba2-780m",
                      "gemma2-2b")

#: enc-dec archs have no 32k self-decode in the usual sense; shapes are
#: applied to the decoder backbone generically (frontend stubbed)
ALL_ARCHS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


def cells(include_skipped: bool = False):
    """The assigned (arch x shape) matrix — 40 cells; long_500k cells for
    pure full-attention archs are skipped per the assignment."""
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            skipped = (shape == "long_500k"
                       and arch not in LONG_CONTEXT_ARCHS)
            if skipped and not include_skipped:
                continue
            yield arch, shape, skipped


__all__ = ["ARCHS", "ALL_ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "cells",
           "get_config", "get_smoke_config", "reduced"]
