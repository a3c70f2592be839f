"""hubert-xlarge — encoder-only audio transformer (w2v2 arch)
[arXiv:2106.07447]. 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Modality frontend is a stub: inputs are precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", causal=False, frontend="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, max_seq=65_536,
)
