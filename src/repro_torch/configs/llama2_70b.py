"""llama2-70b — the paper's end-to-end inference model (§5.2)
[arXiv:2307.09288]. 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=32000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32000, max_seq=4096,
)
