"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437].
61L d_model=7168 128H, MoE d_ff=2048 (dense head layers 18432), vocab 129280."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129280,
    mla=True, mla_q_rank=1536, mla_kv_rank=512, mla_rope_dim=64,
    mla_nope_dim=128, mla_v_dim=128,
    moe=True, num_experts=256, top_k=8, num_shared_experts=1,
    moe_d_ff=2048, first_dense_layers=3,
    mtp=True, rope_theta=1e4,
)
