"""phi-3-vision-4.2b — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct]. 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab 32064. Vision frontend is a STUB: input_specs() supplies
576 precomputed patch embeddings (B, 576, d)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    frontend="vision", frontend_tokens=576,
)
