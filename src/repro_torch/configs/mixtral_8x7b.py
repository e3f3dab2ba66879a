"""mixtral-8x7b — 8 experts top-2, SWA [arXiv:2401.04088].
32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab 32000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    attn_type="swa", window=4096, rope_theta=1e6,
    moe=True, num_experts=8, top_k=2, moe_d_ff=14336,
)
