"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf] — 30L d_model=576 9H
(GQA kv=3) d_ff=1536 vocab=49152, llama architecture. Also the end-to-end
training example target (examples/train_lm.py)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    unit=(LayerSpec(kind="attn"),),
    n_units=30,
    mlp_kind="swiglu",
    tie_embeddings=True,
)
