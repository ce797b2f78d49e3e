"""recurrentgemma-9b [arXiv:2402.19427] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000; Griffin RG-LRU : local-attention in a 2:1 pattern
(38 = 12 x (rec, rec, attn) + 2-rec tail), local window 2048."""
from repro_torch.models.config import LayerSpec, ModelConfig, RecSpec

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    unit=(LayerSpec(kind="rec"), LayerSpec(kind="rec"),
          LayerSpec(kind="attn", window=2048)),
    n_units=12,
    tail=(LayerSpec(kind="rec"), LayerSpec(kind="rec")),
    mlp_kind="geglu",
    emb_scale=True,
    rec=RecSpec(conv_width=4, d_rec=None),
)
