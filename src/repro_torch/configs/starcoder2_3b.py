"""starcoder2-3b [dense] — arXiv:2402.19173 (hf tier).  30L, d_model 3072,
24 heads (GQA kv=2), d_ff 12288, vocab 49152, RoPE, QKV bias, classic
(non-gated) GELU MLP.  ~3.0B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    mlp_gated=False,
    mlp_act="gelu",
    rope_theta=100_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=173,
    qkv_bias=True,
    mlp_gated=False,
    mlp_act="gelu",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
