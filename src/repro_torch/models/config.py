"""Model configuration for the assigned architectures.

The port's own copy of ``repro/models/config.py`` (it imports nothing of
``repro``); the two must stay identical in what they compute.

One frozen dataclass describes every architecture in the pool: dense GQA
transformers, MoE transformers, Mamba2 (SSD) stacks, and the RG-LRU/local-
attention hybrid.  A model is a repeating ``block_pattern`` of typed blocks:

  - ``attn``   : full causal GQA attention  + dense SwiGLU FFN
  - ``attn_moe``: full causal GQA attention + MoE FFN (top-k routing)
  - ``local``  : sliding-window causal attention + dense FFN
  - ``rglru``  : RG-LRU recurrent mixer (Griffin) + dense FFN
  - ``mamba2`` : Mamba2 SSD mixer, no separate FFN

``num_layers`` need not be a multiple of ``len(block_pattern)``: the decoder
scans over the full pattern groups and unrolls the remainder (e.g.
recurrentgemma's 26 = 8 x (rglru, rglru, local) + (rglru, rglru)).

Input modes (modality frontends are stubs per the assignment):
  - ``tokens``        : ordinary token ids (B, S)
  - ``codebooks``     : K parallel EnCodec token streams (B, S, K); the
                        embedding is the sum of K codebook embeddings and the
                        output is K parallel vocab heads (musicgen).
  - ``tokens+patches``: token ids (B, S) plus precomputed ViT patch embeddings
                        (B, num_patches, d_model) that replace (early-fusion)
                        the first ``num_patches`` token positions (internvl2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

BlockType = Literal["attn", "attn_moe", "local", "rglru", "mamba2"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    block_pattern: tuple[BlockType, ...] = ("attn",)

    # -- attention ----------------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False          # per-head RMSNorm on q and k (qwen3)
    qkv_bias: bool = False         # bias on q/k/v projections (qwen2)
    local_window: int = 2048       # window for ``local`` blocks
    attn_logit_softcap: float = 0.0  # 0 = off

    # -- FFN ------------------------------------------------------------------
    mlp_gated: bool = True         # SwiGLU/GeGLU (False: classic 2-matrix MLP)
    mlp_act: str = "silu"          # silu | gelu

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0           # expert hidden width (may differ from d_ff)
    shared_expert: bool = False    # llama4-style always-on shared expert
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    capacity_factor: float = 1.25

    # -- Mamba2 (SSD) ---------------------------------------------------------
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256           # SSD chunk length for training
    conv_width: int = 4

    # -- RG-LRU ---------------------------------------------------------------
    rnn_width: int = 0             # 0 -> d_model

    # -- io / modality --------------------------------------------------------
    input_mode: str = "tokens"     # tokens | codebooks | tokens+patches
    num_codebooks: int = 1
    num_patches: int = 0
    tie_embeddings: bool = True

    # -- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------------
    def __post_init__(self):
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, "GQA grouping"
        for b in self.block_pattern:
            assert b in ("attn", "attn_moe", "local", "rglru", "mamba2"), b
        if "attn_moe" in self.block_pattern:
            assert self.num_experts > 0 and self.top_k > 0

    # -- derived sizes --------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.d_inner % self.ssm_headdim == 0
        return self.d_inner // self.ssm_headdim

    @property
    def d_rnn(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def num_groups(self) -> int:
        """Full repetitions of the block pattern (scanned)."""
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_blocks(self) -> tuple[BlockType, ...]:
        """Trailing blocks that do not fill a whole pattern (unrolled)."""
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def layer_types(self) -> tuple[BlockType, ...]:
        return self.block_pattern * self.num_groups + self.remainder_blocks

    def block_params_m(self, block: BlockType) -> float:
        """Approximate parameter count (in millions) of one block."""
        d = self.d_model
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        ffn = (3 if self.mlp_gated else 2) * d * self.d_ff
        if block == "attn":
            return (attn + ffn) / 1e6
        if block == "local":
            return (attn + ffn) / 1e6
        if block == "attn_moe":
            e = 3 * d * self.d_ff_expert
            total = attn + self.num_experts * e + d * self.num_experts
            if self.shared_expert:
                total += e
            return total / 1e6
        if block == "mamba2":
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            return (d * 2 * di + d * 2 * g * n + d * h + di * d) / 1e6
        if block == "rglru":
            dr = self.d_rnn
            return (d * dr * 2 + dr * d + 3 * dr + ffn) / 1e6
        raise ValueError(block)

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + final norm)."""
        total = self.vocab_size * self.d_model * self.num_codebooks  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model * self.num_codebooks
        for b in self.layer_types:
            total += int(self.block_params_m(b) * 1e6)
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.num_experts == 0:
            return self.param_count()
        total = self.param_count()
        for b in self.layer_types:
            if b == "attn_moe":
                unused = (self.num_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
                total -= unused
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    """True if every mixer is O(S) in context length (SSM / RG-LRU / local)."""
    return all(b in ("mamba2", "rglru", "local") for b in cfg.block_pattern)


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, and why not if not.

    Per the assignment: ``long_500k`` needs sub-quadratic context handling —
    run it for SSM/hybrid archs, skip (and document) for pure full-attention.
    """
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, (
            "skip: 524288-token dense KV decode is the quadratic-attention "
            "failure case; arch has full-attention blocks"
        )
    return True, ""
