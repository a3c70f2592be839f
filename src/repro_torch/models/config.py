"""Model configuration schema for every supported architecture family
(the port's copy of ``repro.models.config``; the dtype maps to torch)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0  # defaults to ModelConfig.d_ff


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4      # local conv preceding the scan (mamba-style)
    dt_rank: int = 0         # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # family: 'dense' | 'moe' | 'rwkv6' | 'hybrid' (attn+ssm) | 'encoder'
    family: str = "dense"

    # attention variants
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size (SWA)
    local_global_period: int = 1          # e.g. 6 => 5 local : 1 global
    rope_theta: float = 10_000.0
    causal: bool = True                    # False for encoders

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"

    # pad attention heads up to this count (0 = off). Production trick
    # for TP axes that don't divide n_heads (llama3.2's 24, hymba's 25
    # vs a 16-way model axis): padded heads are hard-masked to zero
    # contribution, so the math is exact while every projection shards
    # cleanly. (§Perf hillclimb A)
    pad_heads_to: int = 0

    # KV-chunk size of the online-softmax attention (§Perf A3): larger
    # chunks mean fewer scan-carry rescales at more live memory
    attn_chunk: int = 1024

    max_seq: int = 131_072
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"               # parameter/compute dtype
    tie_embeddings: bool = False

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "hybrid"):
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            per_layer += attn + 2 * d  # + norms
        if self.family == "moe":
            e = self.moe.num_experts
            fe = self.moe.d_ff_expert or f
            per_layer += e * (3 * d * fe) + d * e  # experts + router
        elif self.family in ("dense", "encoder"):
            per_layer += 3 * d * f
        elif self.family == "rwkv6":
            per_layer = 4 * d * d + d * d + 2 * d * f + 6 * d  # tmix + cmix
        elif self.family == "hybrid":
            s = self.ssm.state_dim
            per_layer += 2 * d * f  # shared mlp
            per_layer += 2 * d * d + d * s * 2 + d  # ssm head block (approx)
        return emb + self.n_layers * per_layer + 2 * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        fe = self.moe.d_ff_expert or self.d_ff
        dense_like = self.param_count() - self.n_layers * e * 3 * self.d_model * fe
        return dense_like + self.n_layers * k * 3 * self.d_model * fe
