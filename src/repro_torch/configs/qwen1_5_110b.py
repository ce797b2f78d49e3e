"""qwen1.5-110b [hf:Qwen/Qwen1.5-0.5B family; hf] — 80L d_model=8192 64H
(GQA kv=8) d_ff=49152 vocab=152064, QKV bias."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    unit=(LayerSpec(kind="attn"),),
    n_units=80,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
)
