"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596].
24L (dec) + 24L (enc) d_model=1024 16H (kv=16) d_ff=8192 vocab 256206.
Audio frontend is a STUB: input_specs() supplies precomputed frame
embeddings (B, frames, d) for the encoder."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    enc_layers=24, cross_attention=True,
    frontend="audio", frontend_tokens=0,
)
