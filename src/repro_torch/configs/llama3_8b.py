"""llama3-8b — the paper's primary inference/finetune model [Harli §8.1].
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab 128256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
)
