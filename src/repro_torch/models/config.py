"""Model configuration: one dataclass family covering the 10 assigned
architectures (dense / MoE / SSM / hybrid-recurrent / enc-dec / VLM-backbone).

Layer structure is expressed as a repeating ``unit`` of LayerSpecs run
``n_units`` times, plus an optional ``tail`` (for layer counts not divisible
by the unit length, e.g. recurrentgemma's 38 = 12*3 + 2). The dataclasses
are the reference's ``repro.models.config``, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    #: Arctic-style dense residual MLP running in parallel with the experts
    dense_residual_ff: Optional[int] = None
    aux_loss_weight: float = 0.01
    #: token groups for capacity-bounded dispatch. None = derive from the
    #: mesh's batch-sharding degree (shard-local dispatch; the math then
    #: DEPENDS on the mesh, because capacity is bounded per group). Set it
    #: explicitly to pin the dispatch semantics independently of how the
    #: step is sharded — e.g. the sharded-equality suite pins it so the
    #: unsharded reference drops the same tokens as the 8-device run.
    dispatch_groups: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD (state-space duality) layer parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RecSpec:
    """Griffin RG-LRU recurrent block parameters."""
    conv_width: int = 4
    #: lru width; None -> d_model
    d_rec: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating unit."""
    kind: str = "attn"          # "attn" | "rec" | "ssm"
    window: Optional[int] = None  # sliding-window size; None = global attn

    def __post_init__(self):
        assert self.kind in ("attn", "rec", "ssm"), self.kind


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit: Tuple[LayerSpec, ...]
    n_units: int
    tail: Tuple[LayerSpec, ...] = ()
    family: str = "decoder"     # "decoder" | "encdec"
    head_dim: Optional[int] = None   # None -> d_model // n_heads
    # encoder (enc-dec archs only)
    n_enc_units: int = 0
    enc_seq: int = 1500         # stub frontend frames (whisper 30s)
    # VLM stub frontend
    n_patches: int = 0          # >0: patch-embedding prefix (llava)
    # flavor knobs
    mlp_kind: str = "swiglu"    # "swiglu" | "geglu" | "gelu"
    norm: str = "rms"           # "rms" | "ln"
    post_norms: bool = False    # gemma2 pre+post block norms
    qkv_bias: bool = False      # qwen
    tie_embeddings: bool = False
    emb_scale: bool = False     # gemma: embed * sqrt(d)
    logit_softcap: Optional[float] = None  # gemma2 final softcap
    attn_softcap: Optional[float] = None   # gemma2 attention softcap
    rope_theta: float = 10000.0
    pos_embed: str = "rope"     # "rope" | "learned"
    max_seq: int = 524288       # learned pos table size cap
    moe: Optional[MoESpec] = None
    ssm: SSMSpec = SSMSpec()
    rec: RecSpec = RecSpec()
    # numerics
    param_dtype: str = "float32"
    dtype: str = "bfloat16"     # compute dtype
    remat: str = "full"         # "full" | "none" — scan-unit checkpointing
    # Megatron-SP-style sequence sharding of inter-layer activations over
    # the model axis (EXPERIMENTS.md §Perf): shrinks the remat-saved unit
    # boundaries (the dominant train memory term at d_model >= 8k) at the
    # cost of per-layer AG/RS on the sequence dim.
    seq_shard: bool = False
    # int8 KV cache with per-(batch, head, position) scales — halves the
    # dominant decode roofline term (KV reads); beyond-paper (§Perf).
    kv_quant: bool = False
    # init
    init_scale: float = 0.02

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return len(self.unit) * self.n_units + len(self.tail)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 (Megatron-style) so TP sharding divides."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.unit + self.tail)

    @property
    def is_sub_quadratic(self) -> bool:
        """Eligible for long_500k: every attn layer is windowed, or no attn
        at all, or (gemma2-style) attention alternates local/global with a
        bounded-window local majority and O(n)-per-token global decode."""
        attn = [s for s in self.unit + self.tail if s.kind == "attn"]
        if not attn:
            return True
        rec = [s for s in self.unit + self.tail if s.kind != "attn"]
        windowed = [s for s in attn if s.window is not None]
        # all-windowed, or hybrid with recurrent layers, or local+global mix
        return len(windowed) == len(attn) or bool(rec) or bool(windowed)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND."""
        d, v = self.d_model, self.vocab_padded
        hd = self.head_dim_
        total = v * d  # tok embed
        if not self.tie_embeddings:
            total += v * d
        specs = list(self.unit) * self.n_units + list(self.tail)
        for s in specs:
            if s.kind == "attn":
                total += d * self.n_heads * hd  # q
                total += 2 * d * self.n_kv_heads * hd  # kv
                total += self.n_heads * hd * d  # o
            elif s.kind == "rec":
                dr = self.rec.d_rec or d
                total += 2 * d * dr + dr * d + 3 * dr  # x,gate,out + lru
            elif s.kind == "ssm":
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                total += d * (2 * di + 2 * self.ssm.n_groups *
                              self.ssm.d_state + nh)
                total += di * d
            if s.kind != "ssm":
                if self.moe is not None:
                    total += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                    total += d * self.moe.n_experts
                    if self.moe.dense_residual_ff:
                        total += 3 * d * self.moe.dense_residual_ff
                else:
                    n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    total += n_mats * d * self.d_ff
        # encoder stack (approx: same attn+mlp shape)
        for _ in range(self.n_enc_units):
            total += (d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd
                      + 3 * d * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of E experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        n_layers = self.n_layers
        expert_p = 3 * d * self.moe.d_ff_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * expert_p * n_layers
        return full - inactive
