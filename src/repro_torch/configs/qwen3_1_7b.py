"""qwen3-1.7b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B lineage].
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", qk_norm=True,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, max_seq=131_072, rope_theta=1_000_000.0,
)
