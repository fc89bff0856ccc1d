"""qwen3-4b [dense] — hf:Qwen/Qwen3-4B (hf tier).  36L, d_model 2560,
32 heads (GQA kv=8), decoupled head_dim 128 (q_dim 4096 != d_model),
d_ff 9728, vocab 151936, qk-norm, tied embeddings.  ~4.0B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,     # decoupled: q_dim 128 != d_model 64
    d_ff=128,
    vocab_size=151,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
