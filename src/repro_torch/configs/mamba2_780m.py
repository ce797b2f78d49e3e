"""mamba2-780m [arXiv:2405.21060] — 48L d_model=1536 attention-free,
vocab=50280, SSD (state-space duality) with ssm_state=128."""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-780m",
    d_model=1536,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,               # mixer-only layers, no FFN
    vocab=50280,
    unit=(LayerSpec(kind="ssm"),),
    n_units=48,
    tie_embeddings=True,
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, chunk=128,
                conv_width=4, n_groups=1),
)
