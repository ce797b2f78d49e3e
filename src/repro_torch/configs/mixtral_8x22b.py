"""mixtral-8x22b [arXiv:2401.04088; hf] — 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, MoE 8 experts top-2, sliding-window attention."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,           # (expert hidden; dense d_ff unused under MoE)
    vocab=32768,
    unit=(LayerSpec(kind="attn", window=4096),),   # SWA (Mistral heritage)
    n_units=56,
    mlp_kind="swiglu",
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1e6,
)
