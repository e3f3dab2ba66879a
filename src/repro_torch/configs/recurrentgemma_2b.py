"""recurrentgemma-2b — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427]. 26L d_model=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 vocab 256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256000,
    hybrid_pattern="rra", local_window=2048,
    act="gelu", tie_embeddings=True,
)
