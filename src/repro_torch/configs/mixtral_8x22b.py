"""mixtral-8x22b — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", window=4096,
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, moe=MoEConfig(num_experts=8, top_k=2),
    max_seq=1_048_576,
)
