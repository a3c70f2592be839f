"""internvl2-76b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821].
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Vision frontend
is a stub (precomputed patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense", frontend="vision",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, max_seq=131_072,
)
