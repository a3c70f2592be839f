"""rwkv6-7b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; hf]. 32L d_model=4096 d_ff=14336 vocab=65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv6",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536, max_seq=1_048_576,
)
