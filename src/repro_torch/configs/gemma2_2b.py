"""gemma2-2b [arXiv:2408.00118; hf] — 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000; local(4096)+global alternating attention, logit
softcapping (attn 50, final 30), pre+post block norms, GeGLU, tied
embeddings scaled by sqrt(d)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    unit=(LayerSpec(kind="attn", window=4096),   # local
          LayerSpec(kind="attn")),               # global
    n_units=13,
    mlp_kind="geglu",
    post_norms=True,
    tie_embeddings=True,
    emb_scale=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
)
