"""qwen2.5-7b — the paper's second eval model [Harli §8.1].
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab 152064."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, rope_theta=1e6,
)
