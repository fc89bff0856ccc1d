"""musicgen-large [audio] — decoder-only LM over EnCodec tokens,
arXiv:2306.05284 (hf tier).  48L, d_model 2048, 32 heads (MHA: kv=32),
d_ff 8192, vocab 2048 per codebook, 4 parallel codebooks (delay pattern).

The EnCodec audio frontend is a STUB: ``input_specs`` feeds the 4 discrete
token streams directly (B, S, 4); embeddings are the sum of 4 codebook
embeddings; output is 4 parallel 2048-way heads.  Adaptation note: the
reference uses a non-gated GELU MLP (mlp_gated=False) and learned positional
embeddings — we keep RoPE (recorded in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_gated=False,
    mlp_act="gelu",
    input_mode="codebooks",
    num_codebooks=4,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    mlp_gated=False,
    mlp_act="gelu",
    input_mode="codebooks",
    num_codebooks=4,
    tie_embeddings=False,
    param_dtype="float32",
    compute_dtype="float32",
)
