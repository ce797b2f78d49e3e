"""Config helpers: the smoke-test reducer and the input-shape table.

The FULL configs (exact per the assignment) are exercised only via the
dry-run (ShapeDtypeStruct, no allocation); smoke tests run ``reduced()``
versions of the same family on CPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig, MoESpec, SSMSpec


#: assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-runnable smoke config of the same
    family (same layer kinds / unit structure / flavor knobs)."""
    kv = 1 if cfg.n_kv_heads == 1 else 2
    moe = None
    if cfg.moe is not None:
        moe = MoESpec(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            capacity_factor=cfg.moe.capacity_factor,
            dense_residual_ff=64 if cfg.moe.dense_residual_ff else None,
            aux_loss_weight=cfg.moe.aux_loss_weight)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_units=min(cfg.n_units, 2),
        n_enc_units=min(cfg.n_enc_units, 2),
        enc_seq=16 if cfg.n_enc_units else cfg.enc_seq,
        n_patches=8 if cfg.n_patches else 0,
        moe=moe,
        ssm=SSMSpec(d_state=16, head_dim=16, expand=2, chunk=8,
                    conv_width=cfg.ssm.conv_width,
                    n_groups=cfg.ssm.n_groups),
        unit=tuple(_shrink_spec(s) for s in cfg.unit),
        tail=tuple(_shrink_spec(s) for s in cfg.tail),
        max_seq=4096,
        dtype="float32",  # exactness on CPU smoke runs
        remat="none",
    )


def _shrink_spec(s: LayerSpec) -> LayerSpec:
    return LayerSpec(kind=s.kind,
                     window=8 if s.window is not None else None)
