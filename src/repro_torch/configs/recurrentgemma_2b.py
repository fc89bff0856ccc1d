"""recurrentgemma-2b [hybrid] — Griffin, arXiv:2402.19427 (hf tier).
26L, d_model 2560, pattern (RG-LRU, RG-LRU, local-attn) 1:2, 10 heads
(MQA kv=1, head_dim 256), d_ff 7680 (GeGLU), vocab 256000, local window 2048.
26 = 8 full patterns + 2 trailing recurrent blocks.  Runs long_500k
(recurrent state + windowed KV are O(1) in context).  ~2.7B params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rnn_width=2560,
    mlp_act="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    num_layers=5,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=192,
    vocab_size=211,
    block_pattern=("rglru", "rglru", "local"),
    local_window=8,
    rnn_width=64,
    mlp_act="gelu",
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
