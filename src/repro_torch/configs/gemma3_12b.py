"""gemma3-12b — dense GQA, 5 local : 1 global layer pattern, 128k ctx
[hf:google/gemma-3 lineage]. 48L d_model=3840 16H (kv=8) d_ff=15360
vocab=262144; local window 1024, head_dim 256 (decoupled from d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", qk_norm=True,
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144, window=1024, local_global_period=6,
    max_seq=131_072, rope_theta=1_000_000.0,
)
