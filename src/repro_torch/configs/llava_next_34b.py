"""llava-next-34b [hf:llava-hf/llava-v1.6; backbone only] — 60L
d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The anyres vision
tower is a STUB: input_specs() provides precomputed patch embeddings
(B, 576, d) prepended to the text tokens."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    unit=(LayerSpec(kind="attn"),),
    n_units=60,
    mlp_kind="swiglu",
    n_patches=576,        # anyres base grid (24x24), stubbed
    rope_theta=1e6,
)
