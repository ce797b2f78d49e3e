"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf] — 35L d_model=7168
56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2 + dense
residual MLP (Arctic's dense-MoE hybrid: experts run in parallel with a
persistent dense FFN)."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="arctic-480b",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    unit=(LayerSpec(kind="attn"),),                # full attention
    n_units=35,
    mlp_kind="swiglu",
    moe=MoESpec(n_experts=128, top_k=2, d_ff_expert=4864,
                dense_residual_ff=4864),
)
