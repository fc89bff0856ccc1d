"""llama4-maverick-400b-a17b [moe] — 48L, d_model 5120, 40 heads (GQA kv=8),
d_ff 8192, vocab 202048, MoE 128 experts top-1, early fusion.

Source: hf:meta-llama/Llama-4-* (unverified tier).  The one-line spec
(48L x 128e) would be ~773B total if *every* layer were MoE; the published
400B/17B-active figures correspond to interleaved MoE (every other layer) plus
a shared expert — we use block_pattern ("attn", "attn_moe") and a shared
expert, which lands at ~398B total / ~17B active (see DESIGN.md
§Arch-applicability for the reconciliation).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "attn_moe"),
    num_experts=128,
    top_k=1,
    d_ff_expert=8192,
    shared_expert=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=256,
    block_pattern=("attn", "attn_moe"),
    num_experts=8,
    top_k=1,
    d_ff_expert=128,
    shared_expert=True,
    tie_embeddings=False,
    capacity_factor=4.0,
    param_dtype="float32",
    compute_dtype="float32",
)
