"""whisper-small [arXiv:2212.04356] — enc-dec, 12L encoder + 12L decoder,
d_model=768 12H (kv=12) d_ff=3072 vocab=51865. The conv/mel frontend is a
STUB: input_specs() provides precomputed frame embeddings (B, 1500, d)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    unit=(LayerSpec(kind="attn"),),    # decoder self-attn layers
    n_units=12,
    n_enc_units=12,
    enc_seq=1500,                      # 30 s of audio at 50 Hz
    mlp_kind="gelu",
    norm="ln",
    pos_embed="learned",
    qkv_bias=True,
    max_seq=65536,
)
