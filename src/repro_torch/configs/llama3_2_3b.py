"""llama3.2-3b [dense] — hf:meta-llama/Llama-3.2-3B (unverified tier).
28L, d_model 3072, 24 heads (GQA kv=8), d_ff 8192, vocab 128256, tied
embeddings, rope theta 500k.  ~3.2B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=6,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=161,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
