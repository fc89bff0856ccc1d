"""olmoe-1b-7b [moe] — arXiv:2409.02060 (hf tier).  16L, d_model 2048,
16 heads (kv=16), 64 experts top-8, expert d_ff 1024, vocab 50304, qk-norm.
~6.9B total / ~1.3B active.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=("attn_moe",),
    num_experts=64,
    top_k=8,
    d_ff_expert=1024,
    qk_norm=True,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=128,
    block_pattern=("attn_moe",),
    num_experts=8,
    top_k=4,
    d_ff_expert=32,
    qk_norm=True,
    tie_embeddings=False,
    capacity_factor=4.0,
    param_dtype="float32",
    compute_dtype="float32",
)
