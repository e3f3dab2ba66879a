"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].
48L d_model=1536, attention-free, ssm_state=128, vocab 50280."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
)
