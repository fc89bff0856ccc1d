"""qwen2-7b [dense] — arXiv:2407.10671 (hf tier).  28L, d_model 3584,
28 heads (GQA kv=4), d_ff 18944, vocab 152064, QKV bias, untied embeddings.
~7.6B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=157,
    qkv_bias=True,
    tie_embeddings=False,
    param_dtype="float32",
    compute_dtype="float32",
)
