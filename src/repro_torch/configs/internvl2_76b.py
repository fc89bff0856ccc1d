"""internvl2-76b [vlm] — InternViT frontend (STUB) + InternLM2-76B backbone.

Source: arXiv:2404.16821 (unverified tier).  The assignment specifies the
transformer BACKBONE only: 80L, d_model 8192, 64 heads (GQA kv=8),
d_ff 28672, vocab 128256.  The ViT frontend is a stub — ``input_specs``
supplies precomputed patch embeddings (B, 256, d_model) that early-fuse into
the first 256 token positions.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    input_mode="tokens+patches",
    num_patches=256,
    tie_embeddings=False,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=160,
    vocab_size=199,
    input_mode="tokens+patches",
    num_patches=4,
    tie_embeddings=False,
    param_dtype="float32",
    compute_dtype="float32",
)
