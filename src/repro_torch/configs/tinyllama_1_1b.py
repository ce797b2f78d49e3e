"""tinyllama-1.1b [arXiv:2401.02385; hf] — 22L d_model=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000, llama2 architecture."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    unit=(LayerSpec(kind="attn"),),
    n_units=22,
    mlp_kind="swiglu",
)
