"""Model configuration shared by every architecture family.

One frozen (hashable -> jit-static) dataclass covers the whole assigned
pool: dense / MoE / MLA / SSM / hybrid / VLM / audio backbones. The
port's copy of ``repro.models.config`` keeps every field, so a manifest
written by the JAX package rebuilds the same config here; the port's
model code serves every one of those families (:func:`check_family`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False           # qwen1.5-style bias on q/k/v
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden size
    first_k_dense: int = 0           # deepseek: leading dense-FFN layers
    dense_d_ff: int = 0              # hidden size of those dense layers
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0            # 0 => standard GQA attention
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # --- hybrid (zamba2): one *shared* attention block every k SSM layers
    attn_every: int = 0

    # --- attention windowing (lets the hybrid run 500k decode) ---
    sliding_window: int = 0          # 0 => full causal

    # --- VLM: every k-th layer is a gated cross-attention layer ---
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # --- audio (musicgen): multi-codebook token streams ---
    n_codebooks: int = 0

    # --- execution policy ---
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 2048           # sequence-chunked cross-entropy; 0 = off
    grad_accum: int = 1              # microbatch accumulation inside train_step
    flash_threshold: int = 4096      # use flash-chunked attention at S >= this
    flash_q_chunk: int = 512
    flash_kv_chunk: int = 1024

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        assert self.family in FAMILIES
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    # ---- derived ----
    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_ssm_layer_stack(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        # total depthwise-conv channels across the x/B/C streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def qk_head_dim(self) -> int:
        if self.is_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim


def check_family(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless `cfg`'s family is one the port
    serves, which is every family of the JAX package: dense, MoE (GQA or
    MLA attention), SSM (Mamba2 blocks over a per-slot recurrent state),
    hybrid (zamba2: the Mamba2 stack plus one shared attention block over
    a ring-paged sliding-window cache), VLM (llama-3.2-vision: gated
    cross-attention blocks over per-slot image K/V) and audio (musicgen:
    the dense block over frames of ``n_codebooks`` ids)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port serves the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} ({cfg.name})")


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Produce a reduced smoke-test config of the same family."""
    return dataclasses.replace(cfg, **overrides)
