"""mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L, d_model 1536, attention-free, vocab 50280, ssm_state 128.
d_inner = 2*1536 = 3072, headdim 64 -> 48 SSD heads, 1 B/C group.
Runs the long_500k cell (constant-size recurrent state).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    num_layers=48,
    d_model=1536,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("mamba2",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    num_layers=4,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    head_dim=16,
    d_ff=0,
    vocab_size=211,
    block_pattern=("mamba2",),
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_groups=1,
    ssm_chunk=8,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
