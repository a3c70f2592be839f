"""Architecture registry: ``get_config(arch_id)`` + reduced smoke-test
variants + per-arch shape-cell applicability (DESIGN.md §5)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

# arch-id -> module name
_MODULES = {
    "rwkv6-7b": "rwkv6_7b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-76b": "internvl2_76b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-12b": "gemma3_12b",
    "internlm2-1.8b": "internlm2_1_8b",
    "llama3.2-3b": "llama3_2_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "llama2-70b": "llama2_70b",  # the paper's own eval model
}

ARCHS = [a for a in _MODULES if a != "llama2-70b"]  # the assigned ten

# shape cells and the skip rules (DESIGN.md §5)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

_LONG_OK = {"rwkv6-7b", "hymba-1.5b", "mixtral-8x22b", "gemma3-12b"}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cells(arch: str) -> list[str]:
    """Runnable shape cells for an arch (encoder: no decode; long_500k
    only for sub-quadratic/windowed archs)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k"]
    if cfg.family != "encoder":
        out.append("decode_32k")
        if arch in _LONG_OK:
            out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in cells(a)]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-scale config of the same family: tiny dims, same
    structural features (GQA ratio, qk_norm, window pattern, MoE top-k,
    SSM state)."""
    per = cfg.local_global_period
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2 * per,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, 4 // max(1, cfg.group_size)),
        head_dim=32,
        d_ff=256,
        vocab=512,
        max_seq=512,
        dtype="float32",
        window=min(cfg.window, 64) if cfg.window else None,
    )
    if cfg.family == "rwkv6":
        kw.update(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64)
    if cfg.moe:
        kw["moe"] = MoEConfig(num_experts=4, top_k=cfg.moe.top_k)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(state_dim=cfg.ssm.state_dim)
    return dataclasses.replace(cfg, **kw)
