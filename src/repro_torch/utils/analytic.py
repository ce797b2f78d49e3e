"""First-principles (napkin-math) roofline model per (arch x shape x mesh),
the port of the reference's ``utils/analytic.py``, formula for formula,
with the three-term ``Roofline`` of its ``utils/hlo.py``.

The terms are computed from the model math: the port compiles no program
whose cost a compiler could report (the reference's HLO parser,
``hlo.collective_bytes``, has no counterpart). The rates are one NVIDIA
H100 SXM's (NVIDIA's data sheet, dense): 989 TFLOP/s bf16, 3.35 TB/s of
device memory, and 450 GB/s each way over NVLink -- a link rate that holds
only among the eight cards of one host; a mesh of 256 or 512 chips spans
hosts, whose network is slower, so ``t_collective`` is a lower bound there.

All byte counts are per device; flops are reported both global and per
device. Collective cost uses ring algorithms: all-gather/reduce-scatter
move size*(n-1)/n per device; all-reduce 2x that.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.common import SHAPES
from repro_torch.models.config import ModelConfig

# NVIDIA H100 SXM constants (per card; the hopper-kernels rates)
PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s each way, NVLink within one host


@dataclasses.dataclass
class MeshModel:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def n_chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:           # batch shards
        return self.pod * self.data


def _ring_ag(size_bytes: float, n: int) -> float:
    """Per-device bytes moved by a ring all-gather of a size/n shard."""
    return size_bytes * (n - 1) / n if n > 1 else 0.0


def _ring_ar(size_bytes: float, n: int) -> float:
    return 2.0 * size_bytes * (n - 1) / n if n > 1 else 0.0


def _layer_specs(cfg: ModelConfig):
    return list(cfg.unit) * cfg.n_units + list(cfg.tail)


def _attn_kv_len(spec_window: Optional[int], s: int) -> float:
    """Average effective kv length per query (causal; window-clipped)."""
    if spec_window is None or spec_window >= s:
        return (s + 1) / 2.0
    w = spec_window
    # first w tokens see (i+1), the rest see w
    return (w * (w + 1) / 2.0 + (s - w) * w) / s


def flops_model(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    """Global flops, split useful (6ND-style) vs executed (incl. remat)."""
    seq, gbatch, kind = SHAPES[shape_name]
    s_text = seq - (cfg.n_patches or 0)
    d = cfg.d_model
    hd = cfg.head_dim_

    if kind == "train":
        tokens = gbatch * s_text
        s_ctx = s_text
    elif kind == "prefill":
        tokens = gbatch * s_text
        s_ctx = s_text
    else:
        tokens = gbatch * 1
        s_ctx = seq  # attends over the full cache

    # --- matmul params touched per token (active for MoE)
    n_active = cfg.active_param_count()
    mat_flops_fwd = 2.0 * n_active * tokens

    # --- attention score/value flops (not in 6ND)
    attn_flops_fwd = 0.0
    for spec in _layer_specs(cfg):
        if spec.kind != "attn":
            continue
        if kind == "decode":
            kv = min(spec.window, s_ctx) if spec.window else s_ctx
        else:
            kv = _attn_kv_len(spec.window, s_ctx)
        attn_flops_fwd += 4.0 * cfg.n_heads * hd * kv * tokens
    # encoder stack (bidirectional, enc_seq ctx) for enc-dec
    if cfg.family == "encdec" and kind != "decode":
        enc_tokens = gbatch * cfg.enc_seq
        attn_flops_fwd += (4.0 * cfg.n_heads * hd * cfg.enc_seq
                           * enc_tokens * cfg.n_enc_units)
        # cross-attention reads enc memory from every decoder layer
        attn_flops_fwd += (4.0 * cfg.n_heads * hd * cfg.enc_seq
                           * tokens * cfg.n_units)
    if cfg.family == "encdec" and kind == "decode":
        attn_flops_fwd += (4.0 * cfg.n_heads * hd * cfg.enc_seq
                           * tokens * cfg.n_units)

    # --- SSD state flops (chunked scan; not matmul-param flops)
    ssd_fwd = 0.0
    n_ssm = sum(1 for sp in _layer_specs(cfg) if sp.kind == "ssm")
    if n_ssm:
        s_ssm = cfg.ssm
        d_in = s_ssm.expand * d
        if kind == "decode":
            # state update: dt*B x + C.h per head: ~4 * d_in * N
            ssd_fwd = 4.0 * d_in * s_ssm.d_state * tokens * n_ssm
        else:
            # intra-chunk quadratic (~2*L*(d_in + h*N)) + states
            l_ = s_ssm.chunk
            per_tok = 2.0 * l_ * d_in + 4.0 * d_in * s_ssm.d_state
            ssd_fwd = per_tok * tokens * n_ssm

    fwd = mat_flops_fwd + attn_flops_fwd + ssd_fwd
    useful = fwd if kind != "train" else 6.0 * n_active * tokens

    if kind == "train":
        # fwd + bwd(2x) + full-remat recompute (~1x fwd)
        remat = 1.0 if cfg.remat == "full" else 0.0
        executed = fwd * (3.0 + remat) + attn_flops_fwd * (3.0 + remat) * 0
    else:
        executed = fwd
    return {"useful": useful, "executed": executed, "fwd": fwd,
            "attn_fwd": attn_flops_fwd, "tokens": float(tokens)}


def bytes_model(cfg: ModelConfig, shape_name: str, mesh: MeshModel
                ) -> Dict[str, float]:
    """Per-device HBM bytes per step (dominant terms)."""
    seq, gbatch, kind = SHAPES[shape_name]
    s_text = seq - (cfg.n_patches or 0)
    d = cfg.d_model
    n_params = cfg.param_count()
    dp, tp = mesh.dp, mesh.model

    if kind == "train":
        p_bytes = 4.0 * n_params / mesh.n_chips     # fp32 sharded (FSDP+TP)
        opt_bytes = 8.0 * n_params / mesh.n_chips   # m+v fp32
        if cfg.param_count() > 5e10:
            opt_bytes = 2.0 * n_params / mesh.n_chips + 0.1e9  # int8 m/v
        grad_bytes = 4.0 * n_params / mesh.n_chips
        b_local = gbatch / dp
        sp_div = tp if (cfg.seq_shard and s_text % tp == 0) else 1
        act_bytes = (b_local * s_text * d * 2.0      # bf16 unit boundaries
                     * (len(cfg.unit) and cfg.n_units)) / sp_div
        logits_bytes = (b_local * s_text * cfg.vocab_padded * 4.0 / tp
                        if cfg.vocab_padded % tp == 0
                        else b_local * s_text * cfg.vocab_padded * 4.0)
        # params touched 3x (fwd, remat, bwd) + grads + opt read/write
        total = (3.0 * p_bytes + 2.0 * grad_bytes + 2.0 * opt_bytes
                 + 3.0 * act_bytes + 3.0 * logits_bytes)
        return {"total": total, "params": p_bytes, "opt": opt_bytes,
                "acts": act_bytes, "logits": logits_bytes}

    p_bytes = 2.0 * n_params / mesh.n_chips          # bf16 serve
    if kind == "prefill":
        b_local = gbatch / dp if gbatch % dp == 0 else gbatch
        act_bytes = b_local * s_text * d * 2.0 * cfg.n_layers
        return {"total": p_bytes + act_bytes, "params": p_bytes,
                "acts": act_bytes, "kv": 0.0}

    # decode: params once + KV cache read per token
    kv_elem_bytes = 1.0 + 4.0 / cfg.head_dim_ if cfg.kv_quant else 2.0
    kv_bytes = 0.0
    for spec in _layer_specs(cfg):
        if spec.kind == "attn":
            s_kv = min(spec.window, seq) if spec.window else seq
            per_layer = (2.0 * cfg.n_kv_heads * cfg.head_dim_ * s_kv
                         * kv_elem_bytes)
            kv_bytes += per_layer * gbatch
        elif spec.kind == "ssm":
            d_in = cfg.ssm.expand * d
            nh = d_in // cfg.ssm.head_dim
            kv_bytes += 4.0 * nh * cfg.ssm.head_dim * cfg.ssm.d_state \
                * gbatch
        elif spec.kind == "rec":
            kv_bytes += 4.0 * (cfg.rec.d_rec or d) * gbatch
    if cfg.family == "encdec":
        kv_bytes += (2.0 * cfg.n_heads * cfg.head_dim_ * cfg.enc_seq
                     * 2.0 * gbatch * cfg.n_units)
    kv_bytes /= mesh.n_chips  # cache sharded (batch x heads/seq)
    return {"total": p_bytes + 2.0 * kv_bytes, "params": p_bytes,
            "kv": kv_bytes, "acts": 0.0}


def collective_model(cfg: ModelConfig, shape_name: str, mesh: MeshModel
                     ) -> Dict[str, float]:
    """Per-device collective payload bytes per step."""
    seq, gbatch, kind = SHAPES[shape_name]
    s_text = seq - (cfg.n_patches or 0)
    d = cfg.d_model
    n_params = cfg.param_count()
    dp, tp = mesh.dp, mesh.model
    out: Dict[str, float] = {}

    if kind == "train":
        p_shard = 4.0 * n_params / mesh.n_chips
        # FSDP: AG params (fwd + remat) + RS grads, over the data axis
        out["fsdp_ag"] = 2.0 * _ring_ag(p_shard * mesh.data, mesh.data)
        out["fsdp_rs"] = _ring_ag(p_shard * mesh.data, mesh.data)
        # DP across pods: grads all-reduce over pod axis
        out["pod_ar"] = _ring_ar(4.0 * n_params / (mesh.data * mesh.model),
                                 mesh.pod)
        # TP: 2 all-reduces per layer (attn-out + mlp-out), fwd+bwd.
        # Under SP the ARs become RS+AG pairs — same ring bytes, so the
        # collective term is unchanged (the SP win is the memory term).
        b_local = gbatch / dp
        act = b_local * s_text * d * 2.0
        n_ar = sum(2 if sp.kind == "attn" else 1
                   for sp in _layer_specs(cfg))
        out["tp_ar"] = _ring_ar(act, tp) * n_ar * 2.0
        if cfg.moe is not None:
            # shard-local dispatch (the default): tokens never cross
            # shards; the cross-shard cost is the expert-weight FSDP
            # all-gather over the data axis (fwd + remat'd bwd) + the
            # grads reduce-scatter — already covered by fsdp_* above for
            # the expert share. The old global-dispatch a2a term is gone.
            out["moe_a2a"] = 0.0
    else:
        b_local = gbatch / dp if gbatch % dp == 0 else gbatch
        s_eff = 1 if kind == "decode" else s_text
        act = b_local * s_eff * d * 2.0
        n_ar = sum(2 if sp.kind == "attn" else 1
                   for sp in _layer_specs(cfg))
        out["tp_ar"] = _ring_ar(act, tp) * n_ar
        # MoE: shard-local dispatch — weights replicated for serving (bf16
        # params already counted in bytes_model); no token a2a.
    out["total"] = sum(out.values())
    return out


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one step on one mesh: per-device flops,
    device-memory bytes and collective bytes over the per-card rates
    (equal to the global form global / (chips * peak), since every device
    runs the same program); ``model_flops`` is global and normalised by
    n_chips where compared."""
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective payload bytes
    n_chips: int
    model_flops: float = 0.0     # GLOBAL 6*N*D (6*N_active*D for MoE)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / executed flops (per-device-normalised) -- remat
        and redundancy waste detector (< 1 means extra work)."""
        if not self.flops:
            return 0.0
        return (self.model_flops / self.n_chips) / self.flops

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU implied by the dominant roofline term."""
        if self.t_bound <= 0:
            return 0.0
        per_dev_useful_t = (self.model_flops / self.n_chips) / PEAK_FLOPS
        return per_dev_useful_t / self.t_bound

    def row(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analytic_roofline(cfg: ModelConfig, shape_name: str, mesh: MeshModel
                      ) -> Roofline:
    fl = flops_model(cfg, shape_name)
    by = bytes_model(cfg, shape_name, mesh)
    co = collective_model(cfg, shape_name, mesh)
    return Roofline(
        flops=fl["executed"] / mesh.n_chips,
        hbm_bytes=by["total"],
        coll_bytes=co["total"],
        n_chips=mesh.n_chips,
        model_flops=fl["useful"],
    )
